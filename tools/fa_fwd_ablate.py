#!/usr/bin/env python3
"""Where the tensor-core flash-attention forward spends its time, on one GPU.

    python3 tools/fa_fwd_ablate.py

Builds variants of ``byteps_tpu_torch/csrc/flash_attention.cu``, each the
committed source with one part of ``fa_fwd_wgmma_kernel`` taken out or
changed (by text substitution inside that kernel, so a variant that no
longer applies fails loudly), with the port's nvcc flags, into
``build/ablate/<variant>/`` (``tools/fa_bwd_ablate.py`` does the same for
the backward kernels with ``build_all``). Then
times the forward with lse of each variant at GPT-2 small's attention
shapes (b 8, s 512, h 12, d 64, bf16, causal) as ``chip_smoke.py`` times
the kernels: CUDA-graph replays, variants in turns over 5 windows.

A variant that drops work computes a wrong result: its time only says what
that work costs. Prints one JSON object: the card's name and power limit,
and {variant: [median, min, max] ms}.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

FWD = "fa_fwd_wgmma_kernel"
SOFTMAX = """      softmax_tile<true>(s, m, l, corr, lo, hi, scale_log2);
    }"""
# variant: [(kernel, text, replacement)], each replacing every occurrence of
# the text inside that kernel's definition
VARIANTS = {
    "committed": [],
    # no softmax: p = s, no rescale (the products and copies alone)
    "no_softmax": [
        (FWD, "    if (full) {\n      softmax_tile<false>",
         "    corr[0] = corr[1] = 1.f;\n    if (false) {\n"
         "      softmax_tile<false>"),
        (FWD, SOFTMAX, SOFTMAX.replace("softmax_tile<true>", "if (false) "
                                       "softmax_tile<true>")),
    ],
    # every tile takes the unmasked softmax
    "no_masks": [(FWD, "const bool full =", "const bool full = true || ")],
    # q tiles launched lightest first
    "forward_q_order": [
        (FWD, "const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;",
         "const int q0 = blockIdx.y * BQ;")],
    # no S = Q K^T product (S stays 0)
    "no_qk": [(FWD, "      WgmmaSS<T, 64>::run(s,", "      if (false) "
               "WgmmaSS<T, 64>::run(s,")],
    # no O += P V product
    "no_pv": [(FWD, "      WgmmaRS<T, D>::run(acc,", "      if (false) "
               "WgmmaRS<T, D>::run(acc,")],
}


def edit(src, kernel, old, new):
    """src with every ``old`` inside the definition of ``kernel`` (from its
    name at the start of a line to the first closing brace at the start of
    a line), or anywhere in src when ``kernel`` is None, replaced by
    ``new``; raises if there is none."""
    start, end = 0, len(src)
    if kernel is not None:
        start = src.index(f"\n{kernel}(")
        end = src.index("\n}\n", start)
    body = src[start:end]
    if old not in body:
        raise RuntimeError(f"{old!r} not in {kernel}")
    return src[:start] + body.replace(old, new) + src[end:]


def build(name, edits):
    """The committed source with ``edits`` applied, built with the port's
    nvcc flags into build/ablate/<name>/; returns (name, library path)."""
    from byteps_tpu_torch.ops import _cuda_lib
    src = open(os.path.join(_cuda_lib.CSRC, "flash_attention.cu")).read()
    for kernel, old, new in edits:
        src = edit(src, kernel, old, new)
    out = os.path.join(HERE, "build", "ablate", name)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "flash_attention.cu"), "w") as f:
        f.write(src)
    for header in _cuda_lib.inputs("flash_attention")[1:]:
        shutil.copy(header, out)
    lib = os.path.join(out, "libflash_attention.so")
    subprocess.run([_cuda_lib.nvcc(), *_cuda_lib.NVCC_FLAGS, "-o", lib,
                    os.path.join(out, "flash_attention.cu")],
                   check=True, capture_output=True)
    return name, lib


def build_all(variants):
    """{name: library path}, the variants built in parallel."""
    with ThreadPoolExecutor(len(variants)) as ex:
        return dict(ex.map(lambda kv: build(*kv), variants.items()))


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fa_fwd_ablate: needs a CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import _time_alternating
    libs = build_all(VARIANTS)
    b, s, h, d = 8, 512, 12, 64
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((b, s, h, d), generator=g).to("cuda",
                                                         torch.bfloat16)
               for _ in range(3))
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), device="cuda", dtype=torch.float32)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fns = {}
    for name, path in libs.items():
        fwd = ctypes.CDLL(path).btt_fa_fwd
        fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, f, i, i, p]

        def call(fwd=fwd):
            rc = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     lse.data_ptr(), 1, b, h, s, s, d, d ** -0.5, 1, 0,
                     torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: cudaError {rc}")
        fns[name] = call
    print(json.dumps({"card": card(), "ms": {
        name: list(t) for name, t in _time_alternating(fns).items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
