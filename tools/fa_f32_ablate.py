#!/usr/bin/env python3
"""What the split pass and the extra TF32 products cost the f32 flash
kernels, and what the f32 dQ kernel's shared-memory layout buys, on one GPU.

    python3 tools/fa_f32_ablate.py

Builds variants of ``byteps_tpu_torch/csrc/flash_attention.cu`` as
``tools/fa_fwd_ablate.py`` does (the committed source with one part of
``fa_fwd_tf32_kernel``, ``fa_bwd_dq_tf32_kernel`` or
``fa_bwd_dkv_tf32_kernel`` taken out by text substitution inside that
kernel, into ``build/ablate/<variant>/``, in parallel), then times the f32
forward with lse, dQ and dK/dV of each variant at GPT-2 small's attention
shape in f32 (b 8, s 512, h 12, d 64, causal): CUDA-graph replays,
variants in turns over 5 windows. Variants:
``no_split`` skips the per-tile split pass (each K/V tile's hi/lo and
V^T in the forward and K^T in dQ, each Q/dO tile's hi/lo and transposes in
dK/dV), so committed - no_split is the split's cost; ``hi_only`` keeps one
TF32 product of the three (hi x hi), so committed - hi_only is what the
two small terms cost. The ``dq_*`` variants change only dQ's layout at d
64 (``f32_dq_bk``: keys a tile; ``f32_dq_reg_lo``: Q's and dO's lo halves
in registers or in shared memory), and compute the same result:
``dq_bk64_smem`` (192 KB, one block an SM), ``dq_bk32_smem`` (128 KB, one
block), ``dq_bk16_smem`` (96 KB, two blocks); the committed layout is 32
keys with lo in registers (96 KB, two blocks).

A variant that drops work computes a wrong result: its time only says what
that work costs. Prints one JSON object: the card's name and power limit,
and {variant: {kernel: [median, min, max] ms}}, and for each layout
variant its dQ's largest difference from the committed dQ.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))

FWD, DQ, DKV = ("fa_fwd_tf32_kernel", "fa_bwd_dq_tf32_kernel",
                "fa_bwd_dkv_tf32_kernel")
BK_KNOB = "constexpr int f32_dq_bk() { return D == 128 ? 16 : 32; }"
LO_KNOB = "constexpr bool f32_dq_reg_lo() { return D <= 64; }"


def _off(kernel, text):
    """An edit that skips the statement starting with ``text``."""
    return (kernel, text, "if (false) " + text)


def _layout(keys, reg_lo):
    """Edits of dQ's knobs at d 64: ``keys`` a tile, lo in registers or
    not (the other head dims keep theirs)."""
    return [(None, BK_KNOB, BK_KNOB.replace(": 32;", f": D == 64 ? {keys} "
                                                     ": 32;")),
            (None, LO_KNOB, LO_KNOB.replace("D <= 64", "D <= 64"
                                            if reg_lo else "D < 64"))]


VARIANTS = {
    "committed": [],
    "no_split": [
        _off(FWD, "split_tile<GK::BYTES>(at(kst)"),
        _off(FWD, "split_transpose<BKF, D, false>("),
        _off(DQ, "split_transpose<BKQ, D, true>("),
        _off(DQ, "split_tile<GK::BYTES>(at(vst)"),
        _off(DKV, "split_transpose<BN, D, true>("),
    ],
    "hi_only": [
        _off(FWD, "WgmmaTf32SS<BKF>::run(s, GQ::desc(sQlo"),
        _off(FWD, "WgmmaTf32SS<BKF>::run(s, GQ::desc(sQ + GQ::kstep(j)), "
                  "GK::desc(sKlo"),
        _off(FWD, "WgmmaTf32RS<D>::run(acc, pl"),
        _off(FWD, "WgmmaTf32RS<D>::run(acc, ph + 4 * j, GV::desc(sVl"),
        _off(DQ, "WgmmaTf32RS<BKQ>::run(s, qlo"),
        _off(DQ, "WgmmaTf32SS<BKQ>::run(s, GQ::desc(sQlo"),
        _off(DQ, "WgmmaTf32SS<BKQ>::run(s, GQ::desc(sQ + GQ::kstep(j)), "
                 "GK::desc(sKlo"),
        _off(DQ, "WgmmaTf32RS<BKQ>::run(dp, dolo"),
        _off(DQ, "WgmmaTf32SS<BKQ>::run(dp, GQ::desc(sDOlo"),
        _off(DQ, "WgmmaTf32SS<BKQ>::run(dp, GQ::desc(sDO + GQ::kstep(j)), "
                 "GK::desc(sVlo"),
        _off(DQ, "WgmmaTf32RS<D>::run(acc, al"),
        _off(DQ, "WgmmaTf32RS<D>::run(acc, ah + 4 * j, GT::desc(sKtl"),
        _off(DKV, "WgmmaTf32SS<BN>::run(s, GK::desc(sKlo"),
        _off(DKV, "WgmmaTf32SS<BN>::run(s, GK::desc(sK + GK::kstep(j)), "
                  "GQ::desc(sQlo"),
        _off(DKV, "WgmmaTf32SS<BN>::run(dp, GK::desc(sVlo"),
        _off(DKV, "WgmmaTf32SS<BN>::run(dp, GK::desc(sV + GK::kstep(j)), "
                  "GQ::desc(sDOlo"),
        _off(DKV, "WgmmaTf32RS<D>::run(acc_v, al"),
        _off(DKV, "WgmmaTf32RS<D>::run(acc_v, ah + 4 * j, GT::desc(sDtl"),
        _off(DKV, "WgmmaTf32RS<D>::run(acc_k, al"),
        _off(DKV, "WgmmaTf32RS<D>::run(acc_k, ah + 4 * j, GT::desc(sQtl"),
    ],
    "dq_bk64_smem": _layout(64, False),
    "dq_bk32_smem": _layout(32, False),
    "dq_bk16_smem": _layout(16, False),
}
LAYOUTS = [name for name in VARIANTS if name.startswith("dq_")]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fa_f32_ablate: needs a CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import _time_alternating
    from fa_fwd_ablate import build_all, card
    libs = build_all(VARIANTS)
    b, s, h, d = 8, 512, 12, 64
    g = torch.Generator().manual_seed(1)
    q, k, v, do = (torch.randn((b, s, h, d), generator=g).to("cuda")
                   for _ in range(4))
    o, dk, dv = (torch.empty_like(q) for _ in range(3))
    dqs = {name: torch.zeros_like(q) for name in libs}
    # lse for dQ and dK/dV from the committed forward; each forward writes
    # its own
    lse, lse_out = (torch.empty((b, h, s), device="cuda",
                                dtype=torch.float32) for _ in range(2))
    dvec = torch.zeros_like(lse)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    stream = torch.cuda.current_stream().cuda_stream
    fns = {}

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"launch failed: cudaError {rc}")
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        lib.btt_fa_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, f, i, i,
                                   p]
        lib.btt_fa_bwd_dq.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                                      f, i, i, p]
        lib.btt_fa_bwd_dkv.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i,
                                       i, i, f, i, i, p]
        if name == "committed":
            check(lib.btt_fa_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 o.data_ptr(), lse.data_ptr(), 0, b, h, s, s,
                                 d, d ** -0.5, 1, 0, stream))

        def fwd(lib=lib):
            check(lib.btt_fa_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 o.data_ptr(), lse_out.data_ptr(), 0, b, h,
                                 s, s, d, d ** -0.5, 1, 0,
                                 torch.cuda.current_stream().cuda_stream))

        def dq(lib=lib, out=dqs[name]):
            check(lib.btt_fa_bwd_dq(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), dvec.data_ptr(), out.data_ptr(), 0, b, h, s,
                s, d, d ** -0.5, 1, 0,
                torch.cuda.current_stream().cuda_stream))

        def dkv(lib=lib):
            check(lib.btt_fa_bwd_dkv(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), dvec.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), 0, b, h, s, s, d, d ** -0.5, 1, 0,
                torch.cuda.current_stream().cuda_stream))
        fns[f"{name}/bwd_dq"] = dq
        if name not in LAYOUTS:  # a layout changes dQ alone
            fns[f"{name}/fwd_lse"] = fwd
            fns[f"{name}/bwd_dkv"] = dkv
    torch.cuda.synchronize()
    ms = {}
    for key, t in _time_alternating(fns).items():
        name, kernel = key.split("/")
        ms.setdefault(name, {})[kernel] = list(t)
    print(json.dumps({"card": card(), "ms": ms, "dq_max_abs_diff": {
        name: (dqs[name] - dqs["committed"]).abs().max().item()
        for name in LAYOUTS}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
