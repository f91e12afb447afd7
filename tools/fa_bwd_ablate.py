#!/usr/bin/env python3
"""Where the tensor-core flash-attention backward spends its time, on one GPU.

    python3 tools/fa_bwd_ablate.py

Builds variants of ``byteps_tpu_torch/csrc/flash_attention.cu`` as
``tools/fa_fwd_ablate.py`` does, each with one part of
``fa_bwd_dq_wgmma_kernel`` or ``fa_bwd_dkv_wgmma_kernel`` taken out or
changed: the p / ds recompute, the masks, each product, the dV hi/lo split
of p, and the launch order. Then times the changed kernel of each variant
(and both kernels as committed) at GPT-2 small's attention shapes (b 8,
s 512, h 12, d 64, bf16, causal; lse and D from the plain forward) as
``chip_smoke.py`` times the kernels: CUDA-graph replays, in turns over 5
windows.

A variant that drops work computes a wrong result: its time only says what
that work costs. Prints one JSON object: the card's name and power limit,
and {variant.kernel: [median, min, max] ms}.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from fa_fwd_ablate import build_all, card  # noqa: E402 (tools/ is on the path)

DQ, DKV = "fa_bwd_dq_wgmma_kernel", "fa_bwd_dkv_wgmma_kernel"


def _off(kernel, call):
    """The edit that skips every statement starting with ``call``."""
    return (kernel, call, "if (false) " + call)


# variant: (kernel timed, edits as in fa_fwd_ablate.VARIANTS)
VARIANTS = {
    "committed": (None, []),
    # dQ: no p / ds (ds = S), every tile unmasked, without S = Q K^T,
    # dP = dO V^T or dQ += dS K, q tiles lightest first
    "dq_no_recompute": ("dq", [_off(DQ, "ds_rows<false>("),
                               _off(DQ, "ds_rows<true>(")]),
    "dq_no_masks": ("dq", [(DQ, "const bool inner =",
                            "const bool inner = true ||")]),
    "dq_no_qk": ("dq", [_off(DQ, "WgmmaSS<T, 64>::run(s,")]),
    "dq_no_dov": ("dq", [_off(DQ, "WgmmaSS<T, 64>::run(dp,")]),
    "dq_no_dsk": ("dq", [_off(DQ, "WgmmaRS<T, D>::run(acc,")]),
    "dq_forward_q_order": ("dq", [
        (DQ, "const int q0 = BQ * (gridDim.y - 1 - blockIdx.y);",
         "const int q0 = BQ * blockIdx.y;")]),
    # dK/dV: the same parts, both dV products, the p_lo product and split,
    # K tiles lightest first
    "dkv_no_recompute": ("dkv", [_off(DKV, "p_ds_cols<BN, false>("),
                                 _off(DKV, "p_ds_cols<BN, true>(")]),
    "dkv_no_masks": ("dkv", [(DKV, "const bool inner =",
                              "const bool inner = true ||")]),
    "dkv_no_kq": ("dkv", [_off(DKV, "WgmmaSS<T, BN>::run(s,")]),
    "dkv_no_vdo": ("dkv", [_off(DKV, "WgmmaSS<T, BN>::run(dp,")]),
    "dkv_no_pdo": ("dkv", [_off(DKV, "WgmmaRS<T, D>::run(acc_v,")]),
    "dkv_no_split": ("dkv", [
        (DKV, "split2<T>(s[8 * j + 2 * x], s[8 * j + 2 * x + 1], "
              "ph[4 * j + x], pl[4 * j + x]);",
         "ph[4 * j + x] = pack2<T>(s[8 * j + 2 * x], s[8 * j + 2 * x + 1]);"),
        _off(DKV, "WgmmaRS<T, D>::run(acc_v, pl"),
        (DKV, "    fence_regs(pl);\n", "")]),
    "dkv_no_dsq": ("dkv", [_off(DKV, "WgmmaRS<T, D>::run(acc_k,")]),
    "dkv_backward_k_order": ("dkv", [
        (DKV, "const int k0 = BK * blockIdx.y;",
         "const int k0 = BK * (gridDim.y - 1 - blockIdx.y);")]),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fa_bwd_ablate: needs a CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import _time_alternating
    fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")
    libs = build_all({name: edits for name, (_, edits) in VARIANTS.items()})
    b, s, h, d = 8, 512, 12, 64
    scale = d ** -0.5
    g = torch.Generator().manual_seed(1)
    q, k, v, do = (torch.randn((b, s, h, d), generator=g).to(
        "cuda", torch.bfloat16) for _ in range(4))
    o, lse = fa._fwd_reference(q, k, v, True, scale)
    dvec = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dvec.data_ptr())
    tail = (1, b, h, s, s, d, scale, 1, 0)
    fns = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        lib.btt_fa_bwd_dq.argtypes = [p] * 7 + [i] * 6 + [f, i, i, p]
        lib.btt_fa_bwd_dkv.argtypes = [p] * 8 + [i] * 6 + [f, i, i, p]

        def run(rc, name=name):
            if rc != 0:
                raise RuntimeError(f"{name}: launch failed: cudaError {rc}")

        def call_dq(lib=lib, run=run):
            run(lib.btt_fa_bwd_dq(*head, dq.data_ptr(), *tail,
                                  torch.cuda.current_stream().cuda_stream))

        def call_dkv(lib=lib, run=run):
            run(lib.btt_fa_bwd_dkv(*head, dk.data_ptr(), dv.data_ptr(), *tail,
                                   torch.cuda.current_stream().cuda_stream))
        timed = VARIANTS[name][0]
        if timed in (None, "dq"):
            fns[f"{name}.dq"] = call_dq
        if timed in (None, "dkv"):
            fns[f"{name}.dkv"] = call_dkv
    print(json.dumps({"card": card(), "ms": {
        name: list(t) for name, t in _time_alternating(fns).items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
