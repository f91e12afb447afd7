"""The least time latent attention's flash kernels can take, where q and
k have head dim ``dqk`` (DeepSeek-V3's 128 + 64 rotary = 192) and v and o
``dv`` (128). ``roofline.py``'s yardstick for one head dim d, extended:
operations and bytes counted from the shapes, each input read once and
each output written once, against the same peaks, so the bound is the
same whatever kernel implements the function."""

from __future__ import annotations

from portbench.roofline import HBM_BPS, PEAK_OPS, live_pairs


def ops_per_pair(name: str, dqk: int, dv: int) -> int:
    """Matrix-product operations per live (query, key) pair and head: the
    forward's S over dqk and P V over dv; dQ's S, dP = dO V^T (dv) and dS
    K (dqk); dK/dV's S^T, dP^T, dS^T Q and P^T dO."""
    return {"fwd_lse": 2 * dqk + 2 * dv,
            "bwd_dq": 2 * dqk + 2 * dv + 2 * dqk,
            "bwd_dkv": 2 * (2 * dqk + 2 * dv)}[name]


def bound_ms(name: str, b: int, h: int, s_q: int, s_k: int, dqk: int,
             dv: int, elem: int, causal: bool, dtype: str):
    """(least ms on the card, "bytes" or "operations") of one launch: q, k
    (and dq, dk) at dqk, v, o, dO (and dv) at dv, one f32 a query row for
    lse and D."""
    q, k = b * s_q * h * dqk * elem, b * s_k * h * dqk * elem
    v, o = b * s_k * h * dv * elem, b * s_q * h * dv * elem
    row = b * h * s_q * 4
    ops = ops_per_pair(name, dqk, dv) * b * h * live_pairs(s_q, s_k, causal)
    nbytes = {"fwd_lse": q + k + v + o + row,
              "bwd_dq": q + k + v + o + q + 2 * row,
              "bwd_dkv": q + k + v + o + k + v + 2 * row}[name]
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
