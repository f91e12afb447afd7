"""Flash attention: hand-written Hopper kernels plus their plain versions.

Counterpart of ``byteps_tpu/ops/flash_attention.py``. Layout
``[batch, seq, heads, head_dim]``; any of float32 / bfloat16 / float16 in,
the same dtype out, f32 accumulation. The forward saves ``(q, k, v, o,
lse)`` and the backward recomputes the probabilities blockwise from the
row logsumexp, so memory stays O(seq) end to end.

Four kernels, one per TPU kernel (``csrc/flash_attention.cu``):

============  =====================================  ====================
wrapper       CUDA kernel                            replaces
============  =====================================  ====================
``fwd_lse``   ``fa_fwd_wgmma_kernel<T, D, true>``    ``_fa_kernel``
              (bf16/f16, tensor cores),
              ``fa_fwd_tf32_kernel<D, true>`` (f32,
              three TF32 products a product)
``fwd``       ``fa_fwd_wgmma_kernel<T, D, false>``,  ``_kernel_nolse``
              ``fa_fwd_tf32_kernel<D, false>``
``bwd_dq``    ``fa_bwd_dq_wgmma_kernel<T, D>``       ``_fa_bwd_dq_kernel``
              (bf16/f16, tensor cores),
              ``fa_bwd_dq_tf32_kernel<D>`` (f32,
              three TF32 products a product)
``bwd_dkv``   ``fa_bwd_dkv_wgmma_kernel<T, D>``,     ``_fa_bwd_dkv_kernel``
              ``fa_bwd_dkv_tf32_kernel<D>``
============  =====================================  ====================

Each wrapper runs its plain PyTorch version (``_fwd_reference``,
``_bwd_dq_reference``, ``_bwd_dkv_reference``) when its tensors lie on the
CPU, and launches its kernel, or raises, when they lie on a CUDA device;
``LAUNCHES[name]`` counts kernel launches only. The kernels take head
dims 16, 32, 64 and 128, the same for q, k and v, and latent attention's
192 for q and k with 128 for v (``MIXED_HEAD_DIMS``, bfloat16 and float16
only); the plain versions take any pair.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

_NEG_INF = -1e30
_BIG = 1e30  # lse of a row with no live key: exp(s - lse) is exactly 0

HEAD_DIMS = (16, 32, 64, 128)
# (q and k's head dim, v's) the kernels also take, in bf16 and f16 only
MIXED_HEAD_DIMS = ((192, 128),)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# Kernel launches per wrapper (the plain versions never count).
LAUNCHES = {"fwd_lse": 0, "fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# --- plain PyTorch versions -------------------------------------------------

def _live_mask(s_q: int, s_k: int, causal: bool, window: Optional[int],
               device) -> Optional[torch.Tensor]:
    """[s_q, s_k] bool: top-left aligned causal mask (q_pos >= k_pos, both
    from 0) and the sliding window; None when every key is live."""
    if not causal:
        return None
    qp = torch.arange(s_q, device=device)[:, None]
    kp = torch.arange(s_k, device=device)[None, :]
    mask = qp >= kp
    if window is not None:
        mask = mask & (qp - kp < window)
    return mask


def _acc(t):
    """``t`` in the plain versions' accumulation type: f32, or float64 for
    float64 inputs (the truth the kernels are held to on the card)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _scores(q, k, scale):
    return torch.einsum("bqhd,bkhd->bhqk", _acc(q), _acc(k)) * scale


def _fwd_reference(q, k, v, causal: bool, scale: float,
                   window: Optional[int] = None):
    """Masked softmax attention in f32 (float64 for float64 inputs):
    returns (o in q's dtype, lse [b, h, s_q]). A row with no live key
    gives o = 0 and lse = +1e30, as the kernel's l == 0 guard does; p is
    cast to v's dtype before p.v."""
    s = _scores(q, k, scale)
    mask = _live_mask(q.shape[1], k.shape[1], causal, window, q.device)
    if mask is not None:
        s = s.masked_fill(~mask, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = p * mask
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    pv = torch.einsum("bhqk,bkhd->bhqd", _acc(p.to(v.dtype)), _acc(v))
    o = (pv / safe_l).permute(0, 2, 1, 3).to(q.dtype)
    lse = torch.where(l == 0, torch.full_like(l, _BIG), m + torch.log(safe_l))
    return o, lse[..., 0]


def _recompute(q, k, v, do, lse, dvec, causal, scale, window):
    """p = exp(s - lse) under the mask and ds = p (dO.V^T - D) scale, the
    one place the backward's recompute lives (``_bwd_recompute``)."""
    s = _scores(q, k, scale)
    p = torch.exp(s - lse[..., None])
    mask = _live_mask(q.shape[1], k.shape[1], causal, window, q.device)
    if mask is not None:
        p = p * mask
    dp = torch.einsum("bqhd,bkhd->bhqk", _acc(do), _acc(v))
    ds = p * (dp - dvec[..., None]) * scale
    return p, ds


def _bwd_dq_reference(q, k, v, do, lse, dvec, causal: bool, scale: float,
                      window: Optional[int] = None):
    """dQ = scale * sum_k [p (dO V^T - D)] K, ds cast to k's dtype."""
    _, ds = _recompute(q, k, v, do, lse, dvec, causal, scale, window)
    dq = torch.einsum("bhqk,bkhd->bqhd", _acc(ds.to(k.dtype)), _acc(k))
    return dq.to(q.dtype)


def _bwd_dkv_reference(q, k, v, do, lse, dvec, causal: bool, scale: float,
                       window: Optional[int] = None):
    """dV = sum_q p^T dO (f32 p), dK = scale * sum_q ds^T Q (ds cast to
    q's dtype)."""
    p, ds = _recompute(q, k, v, do, lse, dvec, causal, scale, window)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, _acc(do))
    dk = torch.einsum("bhqk,bqhd->bkhd", _acc(ds.to(q.dtype)), _acc(q))
    return dk.to(k.dtype), dv.to(v.dtype)


def _term_magnitudes(q, k, v, do, lse, dvec, causal: bool, scale: float,
                     window: Optional[int] = None):
    """Sum of |term| behind every element of o, dq, dk and dv (f32):
    P|V|/l, |dS||K|, |dS|^T|Q| and P^T|dO|. A kernel that rounds each
    term at another point than the plain version (p against its running
    max, ds from an f32 value summed in another order) may move each term
    by one ulp, so these bound how far the two can drift before the
    output's own rounding.

    ``dq_dp`` and ``dk_dp`` carry the sums behind each ds one level
    further: scale P (|dO||V|^T), the |term|s of dp = dO V^T, times |K|
    or |Q|. ds = p (dp - D) scale cancels where dp is close to D (a row
    whose probability sits on one key, as the first query under a causal
    mask), and there two f32 evaluations of dp in another order differ by
    more than ds itself."""
    o_mag = _fwd_reference(q, k, v.abs(), causal, scale, window)[0]
    p, ds = _recompute(q, k, v, do, lse, dvec, causal, scale, window)
    ds = ds.abs()
    dp_mag = p * torch.einsum("bqhd,bkhd->bhqk", do.float().abs(),
                              v.float().abs()) * scale
    return {
        "o": o_mag.float(),
        "dq": torch.einsum("bhqk,bkhd->bqhd", ds, k.float().abs()),
        "dk": torch.einsum("bhqk,bqhd->bkhd", ds, q.float().abs()),
        "dv": torch.einsum("bhqk,bqhd->bkhd", p, do.float().abs()),
        "dq_dp": torch.einsum("bhqk,bkhd->bqhd", dp_mag, k.float().abs()),
        "dk_dp": torch.einsum("bhqk,bqhd->bkhd", dp_mag, q.float().abs()),
    }


# --- kernel wrappers --------------------------------------------------------

_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from byteps_tpu_torch.ops import _cuda_lib
        lib = _cuda_lib.load("flash_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.btt_fa_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, f, i,
                                   i, p]
        lib.btt_fa_bwd_dq.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                                      i, f, i, i, p]
        lib.btt_fa_bwd_dkv.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                                       i, i, f, i, i, p]
        for fn in (lib.btt_fa_fwd, lib.btt_fa_bwd_dq, lib.btt_fa_bwd_dkv):
            fn.restype = ctypes.c_int
        lib.btt_error_string.argtypes = [ctypes.c_int]
        lib.btt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _on_cpu(*tensors) -> bool:
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(
            f"flash attention needs all tensors on the CPU or all on one "
            f"CUDA device, got {sorted(str(t.device) for t in tensors)}")
    return False


def _check(q, k, v, *rest):
    """Raise on anything the kernels do not take; ``rest`` are dO (v's
    head dim) for the backward."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash attention kernel takes float32, bfloat16 or "
                        f"float16, got {q.dtype}")
    for t in (k, v, *rest):
        if t.dtype != q.dtype:
            raise TypeError(f"dtype mismatch: {t.dtype} vs q's {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [batch, seq, heads, head_dim]")
    b, s_q, h, d = q.shape
    dv = v.shape[3]
    if (k.shape != v.shape[:3] + (d,) or k.shape[0] != b
            or k.shape[2] != h
            or any(t.shape != (b, s_q, h, dv) for t in rest)):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}"
                         + "".join(f", dO {tuple(t.shape)}" for t in rest))
    if dv == d and d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported by the kernel "
                         f"(takes {HEAD_DIMS})")
    if dv != d and ((d, dv) not in MIXED_HEAD_DIMS
                    or q.dtype == torch.float32):
        raise ValueError(f"head dims (q, k) {d} and (v) {dv} not supported "
                         f"by the kernel in {q.dtype} (takes "
                         f"{MIXED_HEAD_DIMS} in bfloat16 and float16)")
    if min(b, s_q, k.shape[1], h) < 1 or b * h > 65535:
        raise ValueError(f"unsupported sizes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    for t in (q, k, v, *rest):
        if not t.is_contiguous():
            raise ValueError("flash attention kernel needs contiguous "
                             "tensors")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _kernels().btt_error_string(rc).decode()
        raise RuntimeError(f"flash attention {what} launch failed: {msg} "
                           f"(cudaError {rc})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _win(window: Optional[int]) -> int:
    return 0 if window is None else int(window)


def flash_fwd(q, k, v, causal: bool, scale: float,
              window: Optional[int] = None, return_lse: bool = True):
    """Forward: (o, lse f32 [b, h, s_q]) with ``return_lse``, else o."""
    if _on_cpu(q, k, v):
        o, lse = _fwd_reference(q, k, v, causal, scale, window)
        return (o, lse) if return_lse else o
    _check(q, k, v)
    b, s_q, h, d = q.shape
    dv = v.shape[3]
    o = q.new_empty((b, s_q, h, dv))
    lse = (torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
           if return_lse else None)
    rc = _kernels().btt_fa_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if return_lse else None, _DTYPE_CODES[q.dtype], b, h,
        s_q, k.shape[1], d, dv, float(scale), int(causal), _win(window),
        _stream(q))
    _raise_on(rc, "forward")
    LAUNCHES["fwd_lse" if return_lse else "fwd"] += 1
    return (o, lse) if return_lse else o


def _check_rows(q, lse, dvec):
    b, s_q, h, _ = q.shape
    for t in (lse, dvec):
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, h, s_q)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError("lse and D must be contiguous f32 "
                             f"[{b}, {h}, {s_q}] on {q.device}")


def flash_bwd_dq(q, k, v, do, lse, dvec, causal: bool, scale: float,
                 window: Optional[int] = None):
    """dQ from the forward's residuals; ``do`` in q's dtype, ``dvec`` =
    rowsum(dO * O) f32 [b, h, s_q]."""
    if _on_cpu(q, k, v, do, lse, dvec):
        return _bwd_dq_reference(q, k, v, do, lse, dvec, causal, scale,
                                 window)
    _check(q, k, v, do)
    _check_rows(q, lse, dvec)
    b, s_q, h, d = q.shape
    dq = torch.empty_like(q)
    rc = _kernels().btt_fa_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(),
        _DTYPE_CODES[q.dtype], b, h, s_q, k.shape[1], d, v.shape[3],
        float(scale), int(causal), _win(window), _stream(q))
    _raise_on(rc, "dq")
    LAUNCHES["bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, dvec, causal: bool, scale: float,
                  window: Optional[int] = None):
    """(dK, dV) from the forward's residuals (arguments as flash_bwd_dq)."""
    if _on_cpu(q, k, v, do, lse, dvec):
        return _bwd_dkv_reference(q, k, v, do, lse, dvec, causal, scale,
                                  window)
    _check(q, k, v, do)
    _check_rows(q, lse, dvec)
    b, s_q, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = _kernels().btt_fa_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _DTYPE_CODES[q.dtype], b, h, s_q, k.shape[1], d, v.shape[3],
        float(scale), int(causal), _win(window), _stream(q))
    _raise_on(rc, "dk/dv")
    LAUNCHES["bwd_dkv"] += 1
    return dk, dv


# --- autograd ---------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """The ``custom_vjp`` of the JAX version: forward with lse, backward
    through the dQ and dK/dV kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        o, lse = flash_fwd(q, k, v, causal, scale, window, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, window)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale, window = ctx.args
        do = g.to(q.dtype).contiguous()
        # D_i = rowsum(dO * O) in f32, [b, h, s_q] like lse
        dvec = (g.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
        dq = flash_bwd_dq(q, k, v, do, lse, dvec, causal, scale, window)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, dvec, causal, scale, window)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Flash attention over [batch, seq, heads, head_dim] tensors.

    ``window`` (requires ``causal``) restricts each query to the last
    ``window`` positions; tiles left of every query's window are skipped,
    so the work scales with ``seq * window``. ``block_q``/``block_k`` are
    accepted so calls written for the JAX version run unchanged; the
    kernel's 64 x 64 tiles are fixed when it is compiled.

    When no input needs a gradient (evaluation, ``torch.no_grad()``) this
    runs the forward without the logsumexp output.
    """
    del block_q, block_k
    if window is not None and not causal:
        raise ValueError("window requires causal=True (sliding-window "
                         "attention is a causal scheme)")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, scale, window)
    return flash_fwd(q, k, v, causal, scale, window, return_lse=False)
