"""The chip's peaks and the least time an attention kernel can take.

Frozen copies of ``chip_smoke.py``'s ``_live_pairs``, ``_ops_per_pair``
and ``_bound_ms`` (and its ``HBM_BPS`` / ``PEAK_OPS``): the benchmark's
yardstick, which later changes to the smoke script or the port do not
move. Operations and bytes are counted from the shapes, each input read
once and each output written once, so the bound is the same whatever
kernel implements the function.
"""

from __future__ import annotations

# H100 SXM published peaks (dense): HBM bytes/s and matrix-product
# operations/s; bf16/fp16 on the tensor cores; f32 held to f32 accuracy
# as three TF32 products a product at the 495 TFLOP/s TF32 rate.
HBM_BPS = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 495e12 / 3}


def live_pairs(s_q: int, s_k: int, causal: bool, window=None) -> int:
    """(query, key) pairs the mask keeps: the work the kernels must do.
    Copy of ``chip_smoke._live_pairs``."""
    if not causal:
        return s_q * s_k
    total = 0
    for qp in range(s_q):
        hi = min(qp, s_k - 1)
        lo = 0 if window is None else max(0, qp - window + 1)
        total += max(0, hi - lo + 1)
    return total


def ops_per_pair(name: str) -> int:
    """Matrix-product operations per live pair and head-dim element that
    the function needs: the forward's S and P V (2 + 2), dQ's S, dP and
    dS K (6), dK/dV's S^T, dP^T, dS^T Q and P^T dO (8). Copy of
    ``chip_smoke._ops_per_pair``."""
    return {"fwd_lse": 4, "fwd": 4, "bwd_dq": 6, "bwd_dkv": 8}[name]


def bound_ms(name: str, b: int, h: int, s_q: int, s_k: int, d: int,
             elem: int, causal: bool, window, dtype: str):
    """(least ms on the card, "bytes" or "operations"): bytes read once
    and written once at the HBM rate against the matrix-product
    operations at the dtype's peak (exp and the rest are not counted).
    Copy of ``chip_smoke._bound_ms``."""
    q_bytes, kv_bytes = b * s_q * h * d * elem, b * s_k * h * d * elem
    row_bytes = b * h * s_q * 4  # one f32 per query row (lse, D)
    ops = ops_per_pair(name) * d * b * h * live_pairs(s_q, s_k, causal,
                                                      window)
    nbytes = {"fwd_lse": 2 * q_bytes + 2 * kv_bytes + row_bytes,
              "fwd": 2 * q_bytes + 2 * kv_bytes,
              "bwd_dq": 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes,
              "bwd_dkv": 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes}[name]
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
