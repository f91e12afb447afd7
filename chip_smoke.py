#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (byteps_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. build: the flash-attention kernels (nvcc, sm_90a) and the C++ PS core
   (g++), both from this checkout's sources, in parallel, into
   build/byteps_tpu_torch/; the SASS of each bf16/f16 instantiation of
   the tensor-core kernels (forward, dQ, dK/dV) must hold HGMMA (wgmma)
   instructions;
2. kernels: each of the four CUDA kernels against its plain PyTorch
   version on the card, at the attention shapes of the main paths (GPT-2
   small: b 8, s 512, h 12, d 64, bf16, causal; BERT-Large: b 32, s 128,
   h 16, d 64, bf16, non-causal; Llama-1B: b 4, s 2048, h 32, d 64, bf16,
   causal), on f32 cases (unaligned s 600, rectangular causal 100 x 260,
   sliding window 64 at s 300) and on the same shape classes in bf16 and
   f16 (plus non-causal 96 x 96); at the main paths' shapes each timed
   beside its plain version, PyTorch's scaled_dot_product_attention, and
   its bound (device time from CUDA graph replays, the kernels and SDPA's
   forward and backward in turns over 5 windows);
3. collective mode: GPT2Small(attn_impl="flash") at full width trains a
   few steps of 8 x 512 tokens through init -> make_train_step with
   AdamW, then runs one evaluation forward under no_grad; the launch
   counts show every kernel ran on that path, and the flash model's
   logits agree with the same weights under plain attention;
4. PS mode: a scheduler and one CPU server (python -m
   byteps_tpu_torch.server) as child processes, this process as worker 0,
   the same steps from the same weights: first make_train_step alone
   (pushes after backward; the server holds only its tensors), then six
   PS paths, one step of each in turns: make_train_step again, and the
   overlapped paths, make_overlapped_train_step with the f32 and the bf16
   wire, make_bucketed_overlap_step with hook-driven (multi) and
   post-backward (single) buckets, and a DistributedOptimizer(AdamW)
   loop. Each must launch the three training kernels 12 times a step and
   match phase 3's losses (rtol 1e-5; the bf16 wire within the bound in
   ``_losses_match``), and the hook-driven ones must have enqueued pushes
   before backward() returned; their step times, exposed communication
   and share of bytes pushed before backward() returned are reported;
5. ResNet-50 (224 x 224, 1000 classes, batch 256, bf16, SGD(0.1, momentum
   0.9), seed-0 weights, bench.py's images) through every one-worker
   path, STEPS steps each: collective make_stateful_train_step (then one
   profiled step), the same step in PS mode, DistributedOptimizer with
   the f32 and the bf16 wire (one hook per parameter, 161 a step), and
   make_async_train_step against a fleet started with
   BYTEPS_ENABLE_ASYNC=1; losses and BatchNorm running averages held to
   the collective path's, no flash kernel launched; then VGG-16 in
   collective mode, 2 steps of batch 64;
6. BERT-Large MLM (BertLarge(flash, bf16), seq 128, batch 32, bench.py's
   tokens and mask, AdamW(1e-4, weight decay 1e-4)): collective
   make_train_step STEPS steps, an evaluation forward held to plain
   attention, a profiled step and the f32 mlm_out's time; the plain PS
   step and DistributedOptimizer in turns in one fleet, losses equal to
   the collective path's (rtol 1e-5); each path launches the forward
   with lse, dQ and dK/dV 24 times a step; then GPT-2 medium in
   collective mode, 2 steps of 8 x 512;
7. Llama-1B (Llama1B(flash, bf16), batch 4 x seq 2048, tokens from
   default_rng(0), lm_loss, the same AdamW): collective STEPS steps, an
   evaluation forward, a profiled step; the same with remat=True, 2
   steps, losses equal to the bit and the forward launched 44 times a
   step; the plain PS step, 3 steps on the f32 wire (4.1 GB each way),
   losses equal to rtol 1e-5, with its D2H / core / H2D split;
8. the user's entry point: the port's launcher (python -m
   byteps_tpu_torch.launcher --local 2 --num-servers 1 --restarts 1 --
   python chip_smoke.py --launched-worker DIR ...) runs two fleets of
   two GPT-2 small workers on the card (rows [4r, 4r + 4) of phase 3's
   tokens each, DistributedOptimizer(AdamW) on the f32 wire, a
   checkpoint by rank 0 after every step, the callbacks, the in-place
   API, and on rank 0 a Timeline of step 3 merged with the core's
   spans): one uninterrupted, one whose rank 0 ends its process after
   checkpointing step 2, restarted by the launcher and resumed from the
   checkpoint. Both must end with the same parameters and AdamW moments
   to the bit (see ``launch_phase``);
9. (run right after phase 3, while this process holds little of the
   card's memory) sequence parallelism and the int8 transport (see
   ``sp_phase``): (a)
   Llama-1B over one row of 8192 tokens, STEPS collective steps in this
   process; then two processes (python chip_smoke.py --sp-worker ...)
   share the card in a gloo group, whose collectives the port stages
   through host memory: (b) the same model, weights, tokens and AdamW
   under Ulysses around the flash kernels (each rank half the sequence,
   the kernels at [1, 8192, 16, 64]) with sp_lm_loss, held to (a)'s
   losses; (c) ring attention against (b)'s configuration at depth 2,
   one forward and backward; (d) GPT-2 small in collective mode over the
   pair through make_train_step with Compression.int8 and then int8_dcn,
   and one quantized all-reduce of real gradients held to the
   quantiser's bound. The kernel phase checks and times the kernels at
   (b)'s shape too.

Stdout ends with the kernels line, the card's name and power limit, and
{"ok": true, "device": {...}}. Exits non-zero, with no result, when CUDA
is not available or any phase fails.
"""

from __future__ import annotations

import collections
import contextlib
import importlib
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS = 4
SEQ, BATCH = 512, 8
# H100 SXM published peaks (dense): HBM bytes/s, bf16/fp16 tensor-core and
# f32 (non-tensor) operations/s.
HBM_BPS = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# --- phase 1: build ----------------------------------------------------------

def build_all():
    from byteps_tpu_torch.core import build as core_build
    from byteps_tpu_torch.ops import _cuda_lib

    results, errors = {}, []

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
            results[name] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(f"{name}: {e}")

    threads = [
        threading.Thread(target=run, args=(
            "flash_attention.cu", lambda: _cuda_lib.build("flash_attention"))),
        threading.Thread(target=run, args=(
            "libbyteps_core", lambda: core_build.build(verbose=False))),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("build failed:\n" + "\n".join(errors))
    log("build seconds:", {k: round(v, 1) for k, v in results.items()})
    return results


def tensor_core_sass():
    """Registers, spills (the ptxas report) and HGMMA instructions (the
    SASS, by cuobjdump) of each bf16/f16 instantiation of the tensor-core
    kernels (forward with and without lse, dQ, dK/dV); raises if one has
    no HGMMA, i.e. does not run on the tensor cores."""
    import re

    from byteps_tpu_torch.ops import _cuda_lib
    with open(os.path.join(_cuda_lib.BUILD_DIR,
                           "flash_attention.nvcc.log")) as f:
        report = f.read()
    kernels = {}
    for m in re.finditer(
            r"Compiling entry function "
            r"'(\w*fa_(?:fwd|bwd_dq|bwd_dkv)_wgmma_kernel\w*)'.*?"
            r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?"
            r"Used (\d+) registers", report, re.S):
        kernels[m.group(1)] = {"registers": int(m.group(4)),
                               "spill_bytes": int(m.group(2))
                               + int(m.group(3)), "hgmma": 0}
    cuobjdump = os.path.join(os.path.dirname(_cuda_lib.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass",
                           _cuda_lib.lib_path("flash_attention")],
                          capture_output=True, text=True, check=True).stdout
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
        elif fn in kernels and "HGMMA" in line:
            kernels[fn]["hgmma"] += 1
    named = {}
    for fn, v in kernels.items():
        m = re.search(r"(fa_\w+?)_wgmma_kernelI(\w+?)Li(\d+)E(?:Lb([01])E)?",
                      fn)
        dtype = "bfloat16" if "bfloat16" in m.group(2) else "float16"
        lse = f" lse={m.group(4)}" if m.group(4) else ""
        named[f"{m.group(1)} {dtype} d{m.group(3)}{lse}"] = v
    # forward: 2 dtypes x 4 head dims x lse or not; dQ and dK/dV: 8 each
    if len(named) != 32 or not all(v["hgmma"] > 0 for v in named.values()):
        raise AssertionError(f"tensor-core kernels: expected 32 "
                             f"instantiations with HGMMA, got {named}")
    log("tensor-core kernels (ptxas, SASS):", json.dumps(named))
    return named


# --- phase 2: kernels against their plain versions ---------------------------

def _time_ms(fn, iters=20, warmup=3):
    """ms per call over one window of ``iters`` calls issued from Python:
    the card's time, or the host's where the host is slower."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _time_alternating(fns, windows=5, iters=20, stream=None):
    """Device ms per call of each function: ``iters`` calls are captured in
    one CUDA graph per function, so the host's launch cost is out of the
    window, and the graphs are replayed in turns (a, b, a, b, ...) for
    ``windows`` windows. Returns {name: (median, min, max)}.

    Warm-up and capture run on ``stream`` (a new one if None). An autograd
    backward runs on the stream of its forward, so a function that calls
    ``torch.autograd.grad`` is captured only if its forward ran on this
    stream, as ``torch.cuda.make_graphed_callables`` arranges."""
    import torch
    side = stream or torch.cuda.Stream()
    graphs = {}
    for name, fn in fns.items():
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name], stream=side):
            for _ in range(iters):
                fn()
    times = {name: [] for name in fns}
    for _ in range(windows):
        for name, g in graphs.items():
            g.replay()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.replay()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / iters)
    del graphs
    return {name: (sorted(t)[len(t) // 2], min(t), max(t))
            for name, t in times.items()}


def _live_pairs(s_q, s_k, causal, window):
    """(query, key) pairs the mask keeps: the work the kernels must do."""
    if not causal:
        return s_q * s_k
    total = 0
    for qp in range(s_q):
        hi = min(qp, s_k - 1)
        lo = 0 if window is None else max(0, qp - window + 1)
        total += max(0, hi - lo + 1)
    return total


def _ops_per_pair(name, dtype):
    """Matrix-product operations per live (query, key) pair and head-dim
    element: the forward's S and P V (2 + 2), dQ's S, dP and dS K (6),
    dK/dV's S^T, dP^T, dS^T Q and P^T dO (8), plus 2 in bf16/f16, where
    dV takes P^T dO twice (p as the sum of two 16-bit halves)."""
    return {"fwd_lse": 4, "fwd": 4, "bwd_dq": 6,
            "bwd_dkv": 8 if dtype == "float32" else 10}[name]


def _bound_ms(name, b, h, s_q, s_k, d, elem, causal, window, dtype):
    """Least time on the card: bytes read once and written once at the HBM
    rate against the matrix-product operations at the peak of the dtype
    (exp and the rest are not counted)."""
    q_bytes, kv_bytes = b * s_q * h * d * elem, b * s_k * h * d * elem
    row_bytes = b * h * s_q * 4  # one f32 per query row (lse, D)
    ops = _ops_per_pair(name, dtype) * d * b * h * _live_pairs(
        s_q, s_k, causal, window)
    nbytes = {"fwd_lse": 2 * q_bytes + 2 * kv_bytes + row_bytes,
              "fwd": 2 * q_bytes + 2 * kv_bytes,
              "bwd_dq": 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes,
              "bwd_dkv": 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes}[name]
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def limit(dtype, what, got, want, mag, mag_dp=None):
    """Element-wise limit of |got - want|, kernel against plain version on
    the same inputs; a worst-case bound from the arithmetic, not a fit.

    lse is f32 in every dtype, from the same exact products summed in
    another order: 1e-5 + 1e-5 |want|. For o, dq, dk, dv, with eps the
    dtype's epsilon (2^-7 bf16, 2^-10 f16, 2^-23 f32) and ``mag`` the sum
    of |term| behind the element (``_term_magnitudes``):
    - the final rounding of each side moves it by at most half an ulp:
      eps * max(|got|, |want|);
    - o, dq and dk in a half dtype sum terms that each side rounds at
      another point (p against the running max in the kernel and the
      final max in the plain version; ds from f32 values that differ in
      their last bit), one rounding of at most eps/2 each: eps * mag;
    - f32 sums of up to ~1600 terms in another order: 1e-4 * mag;
    - dq and dk: each ds = p (dp - D) scale holds an f32 sum dp of d <=
      128 exact products, which the two sides form in another order, each
      within 128 * 2^-23 of its sum of |term| (tensor-core sums truncate):
      3e-5 * mag_dp, with ``mag_dp`` those sums carried to the element
      (``_term_magnitudes``' dq_dp, dk_dp). Where dp is close to D this
      difference is larger than ds itself, so ``mag`` does not cover it;
    - 1e-6, so an element that is 0 on both sides has a limit."""
    import torch
    if what == "lse":
        return 1e-5 + 1e-5 * want.abs()
    eps = torch.finfo(getattr(torch, dtype)).eps
    rounded = dtype != "float32" and what in ("o", "dq", "dk")
    return (1e-6 + eps * torch.maximum(got.abs(), want.abs())
            + ((eps if rounded else 0.0) + 1e-4) * mag
            + (0.0 if mag_dp is None else 3e-5 * mag_dp))


def compare(dtype, what, got, want, mag, mag_dp=None):
    """(max abs error, worst ratio of error to its element's limit,
    finite): the check passes when the ratio is at most 1."""
    import torch
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    ratio = (diff / limit(dtype, what, got, want, mag, mag_dp)).max().item()
    return diff.max().item(), ratio, bool(torch.isfinite(got).all())


CASES = [
    # name, b, s_q, s_k, h, d, dtype, causal, window
    ("gpt2", BATCH, SEQ, SEQ, 12, 64, "bfloat16", True, None),
    # BERT-Large MLM (phase 6): non-causal
    ("bert_large", 32, 128, 128, 16, 64, "bfloat16", False, None),
    # Llama-1B (phase 7): 32 query heads on K/V repeated from 4 KV heads
    ("llama1b", 4, 2048, 2048, 32, 64, "bfloat16", True, None),
    # Llama-1B under Ulysses over 2 ranks (phase 9): 8192 tokens, half the
    # query heads, K/V repeated inside the inner call from 2 KV heads
    ("ulysses_8192", 1, 8192, 8192, 16, 64, "bfloat16", True, None),
    # f32: the FMA kernels
    ("unaligned_f32", 1, 600, 600, 2, 32, "float32", True, None),
    ("rect_causal", 1, 100, 260, 2, 16, "float32", True, None),
    ("window64", 1, 300, 300, 2, 16, "float32", True, 64),
] + [
    # bf16 / f16: the tensor-core kernels on every shape class
    (f"{name}_{dtype}", b, s_q, s_k, h, d, dtype, causal, window)
    for dtype in ("bfloat16", "float16")
    for (name, b, s_q, s_k, h, d, causal, window) in [
        ("unaligned", 1, 600, 600, 2, 32, True, None),
        ("rect_causal", 1, 100, 260, 2, 16, True, None),
        ("full", 1, 96, 96, 2, 32, False, None),
        ("window64", 1, 300, 300, 2, 128, True, 64),
    ]
]
# the main paths' shapes, timed beside their plain versions and SDPA
TIMED = ("gpt2", "bert_large", "llama1b", "ulysses_8192")


def kernel_phase():
    import torch
    import torch.nn.functional as F

    fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")

    failures, errors, readings, report = [], {}, {}, {}
    for (case, b, s_q, s_k, h, d, dtype, causal, window) in CASES:
        dt = getattr(torch, dtype)
        g = torch.Generator().manual_seed(1)

        def rnd(s):
            return torch.randn((b, s, h, d), generator=g).to("cuda", dt)

        q, k, v, do = rnd(s_q), rnd(s_k), rnd(s_k), rnd(s_q)
        scale = 1.0 / math.sqrt(d)
        o, lse = fa.flash_fwd(q, k, v, causal, scale, window)
        o_nl = fa.flash_fwd(q, k, v, causal, scale, window,
                            return_lse=False)
        o_ref, lse_ref = fa._fwd_reference(q, k, v, causal, scale, window)
        dvec = (do.float() * o_ref.float()).sum(-1).permute(
            0, 2, 1).contiguous()
        args = (q, k, v, do, lse_ref, dvec, causal, scale, window)
        dq = fa.flash_bwd_dq(*args)
        dk, dv = fa.flash_bwd_dkv(*args)
        dq_ref = fa._bwd_dq_reference(*args)
        dk_ref, dv_ref = fa._bwd_dkv_reference(*args)
        mag = fa._term_magnitudes(*args)
        torch.cuda.synchronize()

        checks = {
            "fwd_lse": [("o", o, o_ref), ("lse", lse, lse_ref)],
            "fwd": [("o", o_nl, o_ref)],
            "bwd_dq": [("dq", dq, dq_ref)],
            "bwd_dkv": [("dk", dk, dk_ref), ("dv", dv, dv_ref)],
        }
        detail = {}
        for kname, items in checks.items():
            worst = 0.0
            for what, got, want in items:
                err, ratio, finite = compare(dtype, what, got, want,
                                             mag.get(what),
                                             mag.get(what + "_dp"))
                worst = max(worst, err)
                detail[f"{kname}.{what}"] = {
                    "max_abs_err": err, "err_over_limit": ratio}
                if not finite or not ratio <= 1.0:
                    failures.append(f"{case}/{kname}/{what}: error/limit "
                                    f"{ratio:.3f} > 1, max_abs_err {err:.3e}"
                                    f" (finite={finite})")
            errors.setdefault(kname, {})[case] = worst
        readings[case] = detail
        log(f"kernel case {case}: " + json.dumps(detail))

        if case not in TIMED:
            continue
        # Times at the main paths' shapes: kernel, plain version, and
        # PyTorch's SDPA (forward; backward of all three gradients, which
        # stands beside bwd_dq + bwd_dkv: no PyTorch call computes dQ
        # alone).
        elem = q.element_size()
        kt = {
            "fwd_lse": lambda: fa.flash_fwd(q, k, v, causal, scale, window),
            "fwd": lambda: fa.flash_fwd(q, k, v, causal, scale, window,
                                        return_lse=False),
            "bwd_dq": lambda: fa.flash_bwd_dq(*args),
            "bwd_dkv": lambda: fa.flash_bwd_dkv(*args),
        }
        pt = {
            "fwd_lse": lambda: fa._fwd_reference(q, k, v, causal, scale,
                                                 window),
            "fwd": lambda: fa._fwd_reference(q, k, v, causal, scale,
                                             window),
            "bwd_dq": lambda: fa._bwd_dq_reference(*args),
            "bwd_dkv": lambda: fa._bwd_dkv_reference(*args),
        }
        qt, kt_, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            with torch.no_grad():
                return F.scaled_dot_product_attention(qt, kt_, vt,
                                                      is_causal=causal)
        # SDPA's forward runs once, on the stream the graphs are captured
        # on, so that its backward alone is captured and timed
        cap = torch.cuda.Stream()
        cap.wait_stream(torch.cuda.current_stream())
        qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt_, vt))
        gout = do.transpose(1, 2)
        with torch.cuda.stream(cap):
            out = F.scaled_dot_product_attention(qg, kg, vg,
                                                 is_causal=causal)

        def sdpa_bwd():
            torch.autograd.grad(out, (qg, kg, vg), gout, retain_graph=True)
        # device time: each kernel and SDPA's forward and backward in
        # turns, 5 windows
        dev = _time_alternating({**kt, "sdpa_fwd": sdpa,
                                 "sdpa_bwd": sdpa_bwd}, stream=cap)

        def sdpa_fwd_bwd():
            o_ = F.scaled_dot_product_attention(qg, kg, vg,
                                                is_causal=causal)
            torch.autograd.grad(o_, (qg, kg, vg), gout)
        sdpa_both = _time_ms(sdpa_fwd_bwd)
        library = {"fwd_lse": dev["sdpa_fwd"], "fwd": dev["sdpa_fwd"],
                   "bwd_dq": dev["sdpa_bwd"], "bwd_dkv": dev["sdpa_bwd"]}
        pairs = b * h * _live_pairs(s_q, s_k, causal, window)
        timed = report[case] = {}
        for kname in kt:
            bound, by = _bound_ms(kname, b, h, s_q, s_k, d, elem, causal,
                                  window, dtype)
            ms, ms_min, ms_max = dev[kname]
            timed[kname] = {
                "ms": ms, "ms_spread": [ms_min, ms_max],
                "eager_ms": _time_ms(kt[kname]),
                "plain_ms": _time_ms(pt[kname], iters=5, warmup=1),
                "bound_ms": bound, "bound_by": by,
                "library_ms": library[kname][0],
                "library_ms_spread": list(library[kname][1:]),
                "tflops": _ops_per_pair(kname, dtype) * d * pairs
                / (ms * 1e-3) / 1e12,
                "bound_share": bound / ms,
            }
        timed["bwd_pair"] = {
            "ms": dev["bwd_dq"][0] + dev["bwd_dkv"][0],
            "sdpa_bwd_ms": dev["sdpa_bwd"][0],
            "sdpa_bwd_ms_spread": list(dev["sdpa_bwd"][1:])}
        timed["sdpa_fwd_bwd_ms"] = sdpa_both
        log(f"kernel times {case} (ms): " + json.dumps(
            {kn: {x: t[x] for x in ("ms", "bound_ms", "plain_ms",
                                    "library_ms")}
             for kn, t in timed.items() if kn in kt}))
        del out, qg, kg, vg
    if failures:
        raise AssertionError("kernel phase failed:\n" + "\n".join(failures))
    report["readings"] = readings
    return errors, report


# --- phases 3 and 4: the main path -------------------------------------------

def _median(xs):
    """Median of the steps after the first, which pays one-time set-up."""
    xs = sorted(xs[1:])
    return xs[len(xs) // 2]


def _tokens(device, rows=BATCH, seq=SEQ, vocab=50257):
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    return torch.from_numpy(
        rng.integers(0, vocab, size=(rows, seq)).astype(np.int64)).to(device)


def _model(attn_impl="flash"):
    import torch

    from byteps_tpu_torch.models import GPT2Small
    return GPT2Small(attn_impl=attn_impl,
                     generator=torch.Generator().manual_seed(0))


def _loss_fn(model, tokens):
    from byteps_tpu_torch.models import lm_loss
    return lm_loss(model(tokens), tokens)


# A language model the script trains: its constructor (``make(attn_impl,
# **kw)``, seed-0 weights on the card), its batch (``batch(device)``, from
# default_rng(0)), its loss, its number of attention layers (flash
# launches per step), its (sequences, sequence length) a batch and its
# vocabulary.
LM = collections.namedtuple("LM", "name make batch loss layers shape vocab")
GPT2 = LM("gpt2_small", _model, _tokens, _loss_fn, 12, (BATCH, SEQ), 50257)


def _train(label, lm=GPT2, steps=STEPS, **make_kw):
    """init -> model -> make_train_step with AdamW(1e-4, weight decay
    1e-4) -> ``steps`` steps, launches counted from zero over exactly the
    training steps, peak memory from just before the model is built."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch import ps
    from byteps_tpu_torch.training import make_train_step
    fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")

    torch.cuda.reset_peak_memory_stats()
    model = lm.make(**make_kw)
    bps.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)
    step = make_train_step(lm.loss, opt)
    batch = lm.batch(bps.device())
    torch.cuda.synchronize()
    losses, times, staging = [], [], []
    fa.reset_launches()
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step(model, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        staging.append(dict(ps.last_timings))
    launches = dict(fa.LAUNCHES)
    _check_launches(label, launches, lm.layers, steps,
                    make_kw.get("remat", False))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: non-finite losses {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"{label}: losses {losses} step ms {[round(t, 1) for t in times]} "
        f"peak {peak_gb:.2f} GB")
    return model, step, batch, losses, times, staging, launches, peak_gb


def _profile_step(run):
    """Three more training steps, ``run()``. The first is timed on the
    host: the time ``run()`` takes to return (the host enqueueing the
    step) against the time to the synchronize after it; the two are close
    when the host sets the step. The second measures the card's own time
    for the step: the card sleeps (``torch.cuda._sleep``) while the host
    enqueues the whole step behind it, so CUDA events around the step time
    its kernels back to back, with no wait for the host (unless the step
    itself waits for the card: ``device_ms_exact``); 1 - that time / the
    unprofiled step is the idle share. The third runs under
    torch.profiler (CUDA activity): device time by kernel family, the
    union of the kernels' intervals and their span. The profiler can lose
    kernels (ResNet-50's profile kept a fifth of the card's time), so
    ``profiled_share`` (union / the card's time) says how much of the step
    the families cover. The caller adds the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    host = {"enqueue_ms": (t1 - t0) * 1e3,
            "step_ms": (time.perf_counter() - t0) * 1e3}
    before, start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(3))
    before.record()
    torch.cuda._sleep(1_000_000_000)  # ~0.5 s at the H100's clocks
    start.record()
    t0 = time.perf_counter()
    run()
    host["enqueue_behind_sleep_ms"] = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end)
    # Exact when the host enqueued the whole step while the card slept. A
    # step that waits for the card inside (a host-device sync) leaves the
    # card idle while the host enqueues the rest; device_ms then counts
    # that idle time too, and the idle share is a lower bound.
    host["sleep_ms"] = before.elapsed_time(start)
    host["device_ms_exact"] = (host["enqueue_behind_sleep_ms"]
                               < host["sleep_ms"])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and "#" not in ev.name)
    union_us, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            union_us += b - a
            end = b
        elif b > end:
            union_us += b - end
            end = b
    by_name = {}
    for ev in prof.events():
        # device-side events, without the ranges that record_function
        # annotations (Optimizer.step#AdamW.step, ...) mirror there
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and "#" not in ev.name):
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us())
    families = dict.fromkeys(("flash_attention", "convolution", "matmul",
                              "reduction", "elementwise", "other"), 0.0)
    for name, us in by_name.items():
        low = name.lower()
        if "fa_fwd_" in name or "fa_bwd_" in name:
            families["flash_attention"] += us
        elif any(k in low for k in ("fprop", "dgrad", "wgrad", "conv")):
            families["convolution"] += us
        elif any(k in low for k in ("gemm", "cutlass", "xmma", "nvjet")):
            families["matmul"] += us
        elif "reduce" in low:
            families["reduction"] += us
        elif "elementwise" in low:
            families["elementwise"] += us
        else:
            families["other"] += us
    busy = sum(families.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    flash = {k: sum(us for name, us in by_name.items() if k in name) / 1e3
             for k in ("fa_fwd_wgmma_kernel", "fa_fwd_kernel",
                       "fa_bwd_dq_wgmma_kernel", "fa_bwd_dkv_wgmma_kernel",
                       "fa_bwd_dq_kernel", "fa_bwd_dkv_kernel")}
    return {"host_timed_step": host, "device_ms": device_ms,
            "profiled_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_union_ms": union_us / 1e3, "device_events": len(spans),
            "device_span_ms": (spans[-1][1] - spans[0][0]) / 1e3
            if spans else 0.0,
            "profiled_share": union_us / 1e3 / device_ms,
            "family_ms": {k: v / 1e3 for k, v in families.items()},
            "flash_kernel_ms": flash,
            "top_kernels_ms": {k[:80]: v / 1e3 for k, v in top}}


def _evaluate(lm, model, tokens, small):
    """One evaluation forward under no_grad at the full batch: the forward
    kernel without lse once a layer and no other, finite logits of the
    batch's shape; then the same weights under plain attention on
    ``small`` tokens, whose logits must agree with the flash model's
    within 0.1 (bf16 attention outputs may differ by an ulp, which the
    residual stream carries to logits of order 1). Returns (launches,
    the flash-vs-plain max abs error)."""
    import torch
    fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")

    fa.reset_launches()
    with torch.no_grad():
        logits = model(tokens)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    _check_eval_launches(lm.name, launches, lm.layers)
    if (tuple(logits.shape) != (*tokens.shape, lm.vocab)
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"{lm.name} evaluation logits: bad shape or "
                             f"values")
    del logits
    ref = lm.make("full")
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        err = (model(small) - ref(small)).abs().max().item()
    del ref
    if err > 0.1:
        raise AssertionError(f"{lm.name}: flash vs plain attention logits "
                             f"differ by {err}")
    log(f"{lm.name}: flash vs plain-attention logits max_abs_err {err:.3e}")
    return launches, err


def _check_eval_launches(label, launches, layers):
    """An evaluation forward launches the forward without lse once a
    layer and no other kernel."""
    if launches != {"fwd_lse": 0, "fwd": layers, "bwd_dq": 0, "bwd_dkv": 0}:
        raise AssertionError(f"{label} evaluation launches {launches}")


def _profile_lm(label, step, model, batch, times):
    """``_profile_step`` of a collective LM step (the breakdown PERF.md
    reports: a profiler that fails, or sees no device time, fails the
    run); with bf16 activations the forward, dQ and dK/dV must have run
    on the tensor cores."""
    profile = _profile_step(lambda: step(model, batch))
    for name in ("fa_fwd_wgmma_kernel", "fa_bwd_dq_wgmma_kernel",
                 "fa_bwd_dkv_wgmma_kernel"):
        if not profile["flash_kernel_ms"][name] > 0:
            raise AssertionError(f"{label}: profile shows no {name}: "
                                 f"{profile['flash_kernel_ms']}")
    profile["idle_share"] = 1.0 - profile["device_ms"] / _median(times)
    log(f"{label} step profile:", json.dumps(profile))
    return profile


def collective_phase():
    import torch

    import byteps_tpu_torch as bps

    os.environ["BYTEPS_PS_MODE"] = "collective"
    bps.init()
    try:
        model, step, tokens, losses, times, _, launches, _ = _train(
            "collective")
        launches["fwd"] = _evaluate(GPT2, model, tokens,
                                    tokens[:2, :128])[0]["fwd"]
        profile = _profile_lm("collective", step, model, tokens, times)
        del model
    finally:
        bps.shutdown()
    torch.cuda.empty_cache()
    return losses, times, launches, profile


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _check_launches(label, launches, layers=12, steps=STEPS, remat=False):
    """Each attention layer launches the forward with lse, dQ and dK/dV
    once a training step (the forward twice under remat: once more when
    the backward recomputes the block), and the forward without lse
    never."""
    per_step = layers * steps
    for name, want in (("fwd_lse", per_step * (2 if remat else 1)),
                       ("bwd_dq", per_step), ("bwd_dkv", per_step),
                       ("fwd", 0)):
        if launches[name] != want:
            raise AssertionError(f"{label}: {name} launched "
                                 f"{launches[name]} times, expected {want}")


def _losses_match(label, losses, collective_losses, wire="float32"):
    """With one worker the PS sum is the gradient itself, so an f32 wire
    gives the collective losses to rtol 1e-5. The bf16 wire rounds each
    gradient once a step (relative error <= 2^-8); AdamW's update
    m / sqrt(v) takes a ratio of two such values, so each element of the
    update moves by at most ~1.5 x 2^-8 of itself; SGD with momentum sums
    the rounded gradients, so an element of its update moves by at most
    2^-8 of the sum of their magnitudes, which is the update's own size
    where the element's gradients keep their sign over the few steps on
    one batch. The loss, to first order, moves by that share of how far
    the updates have moved it: the bound is 2^-7 |L_1 - L_k| (the bf16
    epsilon) + 1e-5 |L_k|. The first loss comes before any update and is
    held to rtol 1e-5."""
    for a, b in zip(losses, collective_losses):
        moved = abs(collective_losses[0] - b)
        bound = 1e-5 * abs(b) + (2.0 ** -7 * moved if wire == "bfloat16"
                                 else 0.0)
        if not abs(a - b) <= bound:
            raise AssertionError(f"{label} losses {losses} != collective "
                                 f"{collective_losses} ({wire} wire bound)")


PS_PATHS = ("ps", "overlap_f32", "overlap_bf16", "bucketed_multi",
            "bucketed_single", "distributed_optimizer")


def _ps_path(label, lm=GPT2):
    """A model with the seed-0 weights, phase 3's AdamW and the step of
    one PS path: ``ps`` is make_train_step (push after backward), the
    others overlap the pushes with backward or pipeline them by bucket."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.bucketed import make_bucketed_overlap_step
    from byteps_tpu_torch.overlap import make_overlapped_train_step
    from byteps_tpu_torch.training import make_train_step

    model = lm.make()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)
    if label == "ps":
        bps.broadcast_parameters(model.state_dict(), root_rank=0)
        # tensors of its own, new to the server as the other paths' are
        # (the plain run before the turns used the default prefix)
        return model, make_train_step(lm.loss, opt, ps_prefix="ps_turns")
    if label.startswith("overlap"):
        return model, make_overlapped_train_step(
            lm.loss, opt, prefix=label,
            wire_dtype="bfloat16" if label == "overlap_bf16" else "float32")
    if label.startswith("bucketed"):
        return model, make_bucketed_overlap_step(
            lm.loss, opt, multi_program=label == "bucketed_multi",
            prefix=label)
    dopt = bps.DistributedOptimizer(opt)

    def step(model, tokens):
        dopt.zero_grad()
        t0 = time.perf_counter()
        loss = lm.loss(model, tokens)
        loss.backward()
        t_bwd = time.perf_counter()
        dopt.step()
        step.timings = dict(dopt.timings, start=t0, backward=t_bwd)
        return loss.detach()
    return model, step


def _overlap_record(t):
    """One step's host clock readings (start, backward() returned, each
    push enqueued with its bytes, the last pull waited) as offsets."""
    pushes = t["pushes"]
    return {
        "backward_ms": (t["backward"] - t["start"]) * 1e3,
        "first_push_ms": (min(ts for ts, _ in pushes) - t["start"]) * 1e3,
        "last_push_ms": (max(ts for ts, _ in pushes) - t["start"]) * 1e3,
        "landed_ms": (t["landed"] - t["start"]) * 1e3,
        # communication the step waits for after backward() returned
        "exposed_ms": (t["landed"] - t["backward"]) * 1e3,
        "pushes": len(pushes),
        "bytes": sum(n for _, n in pushes),
        "bytes_before_backward": sum(n for ts, n in pushes
                                     if ts < t["backward"]),
    }


def _ps_paths_in_turns(collective_losses, labels=PS_PATHS, lm=GPT2):
    """STEPS steps of every PS path in ``labels`` from the seed-0 weights,
    in turns: each round runs one step of each path, starting one path
    later than the round before, so that a fleet whose round trip drifts
    over the run weighs on every path alike. The launch counts are set to
    0 just before each step and read just after, and summed per path.
    ``peak_memory_gb`` holds every path's model at once."""
    import gc

    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch import ps
    fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")

    torch.cuda.reset_peak_memory_stats()
    paths = {label: _ps_path(label, lm) for label in labels}
    n_params = len(list(paths[labels[0]][0].parameters()))
    tokens = lm.batch(bps.device())
    rec = {label: {"losses": [], "step_ms": [], "steps": [], "staging": [],
                   "launches": dict.fromkeys(fa.LAUNCHES, 0)}
           for label in paths}
    torch.cuda.synchronize()
    for r in range(STEPS):
        for label in labels[r % len(labels):] + labels[:r % len(labels)]:
            model, step = paths[label]
            out = rec[label]
            fa.reset_launches()
            t0 = time.perf_counter()
            loss = step(model, tokens)
            torch.cuda.synchronize()
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            for k, v in fa.LAUNCHES.items():
                out["launches"][k] += v
            out["losses"].append(loss.item())
            if label == "ps":
                out["staging"].append(dict(ps.last_timings))
            else:
                out["steps"].append(_overlap_record(step.timings))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for _, step in paths.values():
        if hasattr(step, "close"):
            step.close()
    del paths, model, step
    gc.collect()
    torch.cuda.empty_cache()
    for label, out in rec.items():
        losses, times, steps = out["losses"], out["step_ms"], out["steps"]
        out["peak_memory_gb"] = peak_gb
        _check_launches(label, out["launches"], lm.layers)
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{label}: non-finite losses {losses}")
        _losses_match(label, losses, collective_losses,
                      "bfloat16" if label == "overlap_bf16" else "float32")
        out["median_step_ms"] = _median(times)
        log(f"{label}: losses {losses} step ms "
            f"{[round(x, 1) for x in times]}")
        if label == "ps":
            continue
        if any(s["pushes"] != n_params for s in steps):
            raise AssertionError(f"{label}: pushes per step {steps}, "
                                 f"expected one for each of the "
                                 f"{n_params} parameters")
        timed = steps[1:]  # the first step pays one-time set-up
        before = sum(s["bytes_before_backward"] for s in timed)
        if label != "bucketed_single" and before == 0:
            raise AssertionError(f"{label}: no push was enqueued before "
                                 f"backward() returned: {timed}")
        out["exposed_ms_median"] = sorted(
            s["exposed_ms"] for s in timed)[len(timed) // 2]
        out["pushed_before_backward_share"] = before / sum(
            s["bytes"] for s in timed)
        log(f"{label}: exposed ms "
            f"{[round(s['exposed_ms'], 1) for s in steps]} pushed before "
            f"backward {out['pushed_before_backward_share']:.3f}")
    return rec


@contextlib.contextmanager
def _fleet(extra=None):
    """A scheduler and one CPU server (python -m byteps_tpu_torch.server)
    as child processes, with this process's environment set for worker 0
    of one; ``extra`` is added to every role's environment. On leaving,
    the children must exit 0 (after the worker's bps.shutdown()); the
    environment is restored and no child is left running."""
    env = dict(os.environ)
    env.update({
        "DMLC_PS_ROOT_URI": "127.0.0.1",
        "DMLC_PS_ROOT_PORT": str(_free_port()),
        "DMLC_NUM_WORKER": "1",
        "DMLC_NUM_SERVER": "1",
        "PS_HEARTBEAT_INTERVAL": "1",
        "BYTEPS_PS_MODE": "ps",
        "PYTHONPATH": HERE + os.pathsep + env.get("PYTHONPATH", ""),
        **(extra or {}),
    })
    logdir = tempfile.mkdtemp(prefix="chip_smoke_ps_")
    children = []
    saved = dict(os.environ)
    try:
        for role in ("scheduler", "server"):
            out = open(os.path.join(logdir, f"{role}.log"), "w")
            children.append((role, out, subprocess.Popen(
                [sys.executable, "-m", "byteps_tpu_torch.server"],
                env=dict(env, DMLC_ROLE=role), cwd=HERE, stdout=out,
                stderr=subprocess.STDOUT)))
        os.environ.update(env)
        os.environ.update({"DMLC_ROLE": "worker", "DMLC_WORKER_ID": "0"})
        yield
        for role, out, p in children:
            p.wait(timeout=60)
            if p.returncode != 0:
                raise AssertionError(f"{role} exited {p.returncode}")
    finally:
        os.environ.clear()
        os.environ.update(saved)
        for role, out, p in children:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
            with open(out.name) as f:
                tail = f.read()[-2000:]
            if p.returncode != 0 and tail:
                log(f"--- {role} log ---\n{tail}")


def ps_phase(collective_losses):
    import torch

    import byteps_tpu_torch as bps

    with _fleet():
        bps.init()
        try:
            if (bps.rank(), bps.size()) != (0, 1):
                raise AssertionError(f"PS rank/size {bps.rank()}/"
                                     f"{bps.size()}")
            # the plain step first, while the server holds its tensors
            # alone, then every path in turns
            model, _, _, losses, times, staging, launches, _ = _train(
                "ps")
            del model
            _losses_match("ps", losses, collective_losses)
            alone = {"losses": losses, "step_ms": times, "staging": staging,
                     "launches": launches}
            paths = _ps_paths_in_turns(collective_losses)
        finally:
            bps.shutdown()
    torch.cuda.empty_cache()
    return alone, paths


# --- phase 5: ResNet-50 and VGG-16 -------------------------------------------

IMAGE, IMAGE_BATCH, VGG_BATCH, VGG_STEPS = 224, 256, 64, 2


def _images(batch, device):
    """bench.py's ResNet batch: NHWC images from N(0, 1) and labels in
    [0, 1000) from default_rng(0), the images handed over as NCHW (a
    channels_last view of the same array)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    x = rng.standard_normal((batch, IMAGE, IMAGE, 3)).astype(np.float32)
    y = rng.integers(0, 1000, batch)
    return (torch.from_numpy(x).permute(0, 3, 1, 2).to(device),
            torch.from_numpy(y).to(device))


def _resnet():
    import torch

    from byteps_tpu_torch.models import ResNet50
    return ResNet50(num_classes=1000, dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(0))


def _resnet_step(label, model):
    """``run(batch) -> loss`` of one ResNet-50 path with bench.py's
    SGD(0.1, momentum 0.9): ``collective`` and ``ps`` are
    make_stateful_train_step, ``collective_bf16`` the same with the bf16
    compression (the gradients rounded to bf16 and back, the arithmetic
    of the bf16 wire with one worker), ``collective_async`` the same with
    each step's parameters rewritten as p_before + (p_after - p_before)
    in f32 (the arithmetic of the async servers with one worker, which
    add the pushed change to their copy); ``dopt_f32`` / ``dopt_bf16`` a
    user loop around DistributedOptimizer (f32 or bf16 wire), which keeps
    its host clock readings in ``run.timings``; ``async``
    make_async_train_step (which seeds the servers here, before any timed
    step)."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.stateful import (cross_entropy_loss,
                                           make_stateful_train_step)
    from byteps_tpu_torch.training import make_async_train_step

    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    if label in ("collective", "ps"):
        return make_stateful_train_step(model, opt, ps_prefix="resnet_grad")
    if label == "collective_bf16":
        return make_stateful_train_step(model, opt,
                                        compression=bps.Compression.bf16)
    if label == "collective_async":
        step = make_stateful_train_step(model, opt)

        def run_seed_plus_delta(batch):
            before = [p.detach().clone() for p in model.parameters()]
            loss = step(batch)
            with torch.no_grad():
                for p, b in zip(model.parameters(), before):
                    p.copy_(b + (p - b))
            return loss
        return run_seed_plus_delta
    if label == "async":
        step = make_async_train_step(
            lambda m, b: cross_entropy_loss(m(b[0]), b[1]), opt, model,
            prefix="resnet_aparam")

        def run_async(batch):
            model.train()
            return step(batch)
        return run_async
    dopt = bps.DistributedOptimizer(
        opt, compression=(bps.Compression.bf16 if label == "dopt_bf16"
                          else bps.Compression.none))

    def run(batch):
        x, y = batch
        model.train()
        dopt.zero_grad()
        t0 = time.perf_counter()
        loss = cross_entropy_loss(model(x), y)
        loss.backward()
        t_bwd = time.perf_counter()
        dopt.step()
        run.timings = dict(dopt.timings, start=t0, backward=t_bwd)
        return loss.detach()
    run.close = dopt._taps.close
    return run


def _resnet_paths(labels, batch, keep=False):
    """STEPS steps of each path in ``labels``, in turns (each round one
    step of each, starting one path later than the round before), each
    from its own seed-0 model. The flash kernels' launch counts are set to
    0 just before each step and read just after. Records the losses, step
    times, PS staging (``ps.last_timings``), the overlap's host clock
    readings, and the BatchNorm buffers after the last step. With
    ``keep`` the models and steps are returned too."""
    import torch

    from byteps_tpu_torch import ps
    fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")

    paths = {}
    for label in labels:
        model = _resnet()
        paths[label] = (model, _resnet_step(label, model))
    rec = {label: {"losses": [], "step_ms": [], "staging": [], "steps": [],
                   "launches": 0} for label in labels}
    torch.cuda.synchronize()
    for r in range(STEPS):
        for label in labels[r % len(labels):] + labels[:r % len(labels)]:
            model, run = paths[label]
            out = rec[label]
            fa.reset_launches()
            t0 = time.perf_counter()
            loss = run(batch)
            torch.cuda.synchronize()
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            out["launches"] += sum(fa.LAUNCHES.values())
            out["losses"].append(loss.item())
            if label in ("ps", "async"):
                out["staging"].append(dict(ps.last_timings))
            elif label.startswith("dopt"):
                out["steps"].append(_overlap_record(run.timings))
    for label, (model, run) in paths.items():
        rec[label]["stats"] = [b.clone() for b in model.buffers()]
        if hasattr(run, "close"):
            run.close()
    if keep:
        return rec, paths
    del paths, model, run
    torch.cuda.empty_cache()
    return rec


def _stats_match(label, rec, ref):
    """The BatchNorm running averages after STEPS steps against a path
    that does the same arithmetic, leaf by leaf in the max norm: within
    1e-5 of the leaf's largest value (the losses' rtol)."""
    for i, (s, r) in enumerate(zip(rec["stats"], ref["stats"])):
        bound = 1e-5 * r.abs().max().item()
        err = (s - r).abs().max().item()
        if not err <= bound:
            raise AssertionError(f"{label}: BatchNorm buffer {i} differs "
                                 f"from the collective path's by {err} > "
                                 f"{bound}")


def _resnet_summary(label, out, n_params):
    """Checks the path's launches and overlap records; returns its
    readings: step ms, images/s, staging split or exposed communication
    (medians of steps 2-STEPS)."""
    if out["launches"]:
        raise AssertionError(f"resnet50 {label}: {out['launches']} flash "
                             f"kernel launches, expected none")
    step = _median(out["step_ms"])
    got = {"losses": out["losses"], "step_ms": out["step_ms"],
           "median_step_ms": step, "images_per_s": IMAGE_BATCH / step * 1e3}
    if out["staging"]:
        got["staging_ms"] = {k: _median([t[k] * 1e3 for t in out["staging"]])
                             for k in ("d2h_s", "core_s", "h2d_s")}
    if out["steps"]:
        steps = out["steps"]
        if any(t["pushes"] != n_params for t in steps):
            raise AssertionError(f"resnet50 {label}: pushes per step "
                                 f"{[t['pushes'] for t in steps]}, expected "
                                 f"{n_params} (one hook each)")
        timed = steps[1:]
        before = sum(t["bytes_before_backward"] for t in timed)
        if before == 0:
            raise AssertionError(f"resnet50 {label}: no push was enqueued "
                                 f"before backward() returned: {timed}")
        got.update(
            backward_ms=_median([t["backward_ms"] for t in steps]),
            exposed_ms=_median([t["exposed_ms"] for t in steps]),
            pushed_before_backward_share=before / sum(t["bytes"]
                                                      for t in timed),
            bytes_per_step=steps[-1]["bytes"])
    log(f"resnet50 {label}: losses {out['losses']} step ms "
        f"{[round(x, 1) for x in out['step_ms']]}")
    return got


def resnet_phase():
    """ResNet-50 at 224 x 224, 1000 classes, batch 256, bf16, seed-0
    weights, through every one-worker training path (STEPS steps each):
    (a) collective make_stateful_train_step, then one profiled step, in
    turns with the same step under the bf16 compression (a') and with
    the async servers' arithmetic (a'');
    (b) the same step in PS mode and (c) DistributedOptimizer (f32 wire,
    one hook per parameter) in turns in one fleet; (d)
    DistributedOptimizer with the bf16 wire in a fleet of its own (its
    tensors have (c)'s names and another dtype); (e) make_async_train_step
    in a fleet started with BYTEPS_ENABLE_ASYNC=1. (b) and (c) must equal
    (a)'s losses to rtol 1e-5, (d) (a')'s and (e) (a'')'s; (d) and (a')
    must lie within the bf16 bound of (a)'s; the BatchNorm running
    averages must agree with those of the path of the same arithmetic
    (``_stats_match``). (a'') and (e) differ from (a) where a weight's
    p + (p' - p) rounds to another f32 value than p', which the bf16
    forward can carry to a bf16 ulp of the weight: their distance from
    (a)'s losses is reported, not held to a bound. Then VGG-16
    in collective mode, VGG_STEPS steps of batch VGG_BATCH. cuDNN is held
    to deterministic algorithms, so that the paths compute the same
    forward and backward."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import VGG16
    from byteps_tpu_torch.stateful import make_stateful_train_step

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    os.environ["BYTEPS_PS_MODE"] = "collective"
    bps.init()
    try:
        batch = _images(IMAGE_BATCH, bps.device())
        torch.cuda.reset_peak_memory_stats()
        rec, paths = _resnet_paths(
            ("collective", "collective_bf16", "collective_async"), batch,
            keep=True)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        model, run = paths["collective"]
        n_params = len(list(model.parameters()))
        profile = _profile_step(lambda: run(batch))
        profile["idle_share"] = 1.0 - profile["device_ms"] / _median(
            rec["collective"]["step_ms"])
        log("resnet50 collective step profile:", json.dumps(profile))
        del paths, model, run

        vgg = VGG16(num_classes=1000, dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(0))
        vgg_step = make_stateful_train_step(
            vgg, torch.optim.SGD(vgg.parameters(), lr=0.1, momentum=0.9),
            has_batch_stats=False)
        vgg_batch = (batch[0][:VGG_BATCH], batch[1][:VGG_BATCH])
        vgg_rec = {"losses": [], "step_ms": [],
                   "params": sum(p.numel() for p in vgg.parameters())}
        for _ in range(VGG_STEPS):
            t0 = time.perf_counter()
            vgg_rec["losses"].append(vgg_step(vgg_batch).item())
            torch.cuda.synchronize()
            vgg_rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        if not all(math.isfinite(x) for x in vgg_rec["losses"]):
            raise AssertionError(f"vgg16: losses {vgg_rec['losses']}")
        log(f"vgg16: {vgg_rec}")
        del vgg, vgg_step
    finally:
        bps.shutdown()
    torch.cuda.empty_cache()

    for labels, extra in ((("ps", "dopt_f32"), None), (("dopt_bf16",), None),
                          (("async",), {"BYTEPS_ENABLE_ASYNC": "1"})):
        with _fleet(extra):
            bps.init()
            try:
                batch = _images(IMAGE_BATCH, bps.device())
                rec.update(_resnet_paths(labels, batch))
            finally:
                bps.shutdown()
        torch.cuda.empty_cache()

    ref = rec["collective"]
    if not all(math.isfinite(x) for x in ref["losses"]):
        raise AssertionError(f"resnet50 collective: losses {ref['losses']}")
    summary = {}
    same_arithmetic = {"ps": "collective", "dopt_f32": "collective",
                       "dopt_bf16": "collective_bf16",
                       "async": "collective_async"}
    for label, out in rec.items():
        if label in same_arithmetic:
            same = rec[same_arithmetic[label]]
            _losses_match(f"resnet50 {label}", out["losses"], same["losses"])
            _stats_match(f"resnet50 {label}", out, same)
        if label.endswith("bf16"):
            _losses_match(f"resnet50 {label}", out["losses"], ref["losses"],
                          "bfloat16")
        summary[label] = _resnet_summary(label, out, n_params)
        summary[label]["max_loss_rel_diff_to_collective"] = max(
            abs(a - b) / abs(b) for a, b in zip(out["losses"],
                                                ref["losses"]))
    summary["collective"].update(profile=profile, peak_memory_gb=peak_gb)
    return {"resnet50": summary, "vgg16": vgg_rec}


# --- phases 6 and 7: BERT-Large MLM, GPT-2 medium, Llama-1B -------------------

BERT_SEQ, BERT_BATCH = 128, 32
LLAMA_SEQ, LLAMA_BATCH, LLAMA_PS_STEPS, LLAMA_REMAT_STEPS = 2048, 4, 3, 2
GPT2M_STEPS = 2


def _bert(attn_impl="flash"):
    import torch

    from byteps_tpu_torch.models import BertLarge
    return BertLarge(attn_impl=attn_impl, dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(0))


def _bert_batch(device):
    """bench.py's MLM batch: tokens in [0, 1000), then the mask in {0, 1},
    from default_rng(0); the labels are the tokens."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 1000, (BERT_BATCH, BERT_SEQ))
    mask = rng.integers(0, 2, (BERT_BATCH, BERT_SEQ))
    return (torch.from_numpy(tokens).to(device),
            torch.from_numpy(mask).to(device))


def _bert_loss(model, batch):
    from byteps_tpu_torch.models import masked_lm_loss
    tokens, mask = batch
    return masked_lm_loss(model(tokens), tokens, mask)


def _gpt2_medium(attn_impl="flash"):
    import torch

    from byteps_tpu_torch.models import GPT2Medium
    return GPT2Medium(attn_impl=attn_impl,
                      generator=torch.Generator().manual_seed(0))


def _llama(attn_impl="flash", remat=False):
    import torch

    from byteps_tpu_torch.models import Llama1B
    return Llama1B(attn_impl=attn_impl, dtype=torch.bfloat16, remat=remat,
                   generator=torch.Generator().manual_seed(0))


def _llama_tokens(device):
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(
        0, 32000, (LLAMA_BATCH, LLAMA_SEQ))).to(device)


BERT = LM("bert_large", _bert, _bert_batch, _bert_loss, 24,
          (BERT_BATCH, BERT_SEQ), 30522)
GPT2M = LM("gpt2_medium", _gpt2_medium, _tokens, _loss_fn, 24,
           (BATCH, SEQ), 50257)
LLAMA = LM("llama1b", _llama, _llama_tokens, _loss_fn, 22,
           (LLAMA_BATCH, LLAMA_SEQ), 32000)


def _summary(lm, losses, times, launches, peak_gb, **extra):
    """One path's readings: its losses and step times, the median of
    steps 2 on, sequences/s and tokens/s at that median, its launches
    and peak memory."""
    step = _median(times)
    rows, seq = lm.shape
    return {"losses": losses, "step_ms": times, "median_step_ms": step,
            "sequences_per_s": rows / step * 1e3,
            "tokens_per_s": rows * seq / step * 1e3, "launches": launches,
            "peak_memory_gb": peak_gb, **extra}


def _mlm_out_ms(model):
    """Device ms of BERT's f32 ``mlm_out`` ([4096, 1024] x [1024, 30522]
    on the FMA units, TF32 off), forward and backward, on the card."""
    import torch
    d, vocab = model.mlm_out.kernel.shape
    x = torch.randn((BERT_BATCH, BERT_SEQ, d), device=model.mlm_out.kernel.device,
                    requires_grad=True)
    g = torch.randn((BERT_BATCH, BERT_SEQ, vocab), device=x.device)

    def fwd_bwd():
        torch.autograd.backward(model.mlm_out(x), g)
    ms = _time_ms(fwd_bwd, iters=5, warmup=1)
    model.zero_grad(set_to_none=True)
    return ms


def bert_phase():
    """Phase 6. BertLarge(flash, bf16), seed-0 weights, seq 128, batch 32,
    bench.py's MLM batch, AdamW(1e-4, weight decay 1e-4): (a) collective
    make_train_step STEPS steps, one evaluation forward (held to plain
    attention), one profiled step; (b) the plain PS step and (c) the PS
    DistributedOptimizer (f32 wire, one hook per parameter) in turns in
    one fleet, their losses equal to (a)'s to rtol 1e-5. Then GPT-2
    medium in collective mode, GPT2M_STEPS steps of 8 x 512, a run
    check."""
    import torch

    import byteps_tpu_torch as bps

    os.environ["BYTEPS_PS_MODE"] = "collective"
    bps.init()
    try:
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 is on: mlm_out would not be f32")
        model, step, batch, losses, times, _, launches, peak_gb = _train(
            "bert_large collective", BERT)
        n_params = sum(p.numel() for p in model.parameters())
        eval_launches, err = _evaluate(BERT, model, batch[0], batch[0][:2])
        launches["fwd"] = eval_launches["fwd"]
        profile = _profile_lm("bert_large collective", step, model, batch,
                              times)
        mlm_ms = _mlm_out_ms(model)
        log(f"bert_large mlm_out f32 fwd+bwd {mlm_ms:.2f} ms")
        coll = _summary(BERT, losses, times, launches, peak_gb,
                        params=n_params, profile=profile,
                        flash_vs_plain_max_abs_err=err,
                        mlm_out_fwd_bwd_ms=mlm_ms,
                        mlm_out_share=mlm_ms / profile["device_ms"])
        del model, step, batch
        torch.cuda.empty_cache()

        model, step, _, m_losses, m_times, _, m_launches, m_peak = _train(
            "gpt2_medium collective", GPT2M, steps=GPT2M_STEPS)
        medium = _summary(GPT2M, m_losses, m_times, m_launches, m_peak,
                          params=sum(p.numel() for p in model.parameters()))
        del model, step
    finally:
        bps.shutdown()
    torch.cuda.empty_cache()

    with _fleet():
        bps.init()
        try:
            paths = _ps_paths_in_turns(losses, ("ps", "distributed_optimizer"),
                                       BERT)
        finally:
            bps.shutdown()
    torch.cuda.empty_cache()
    out = {"collective": coll}
    for label, p in paths.items():
        out[label] = _summary(
            BERT, p["losses"], p["step_ms"], p["launches"],
            p["peak_memory_gb"],
            # the card does (a)'s work a step; the rest of the step it
            # waits for the round trip
            idle_share_vs_collective_card_ms=1.0 - profile["device_ms"]
            / _median(p["step_ms"]),
            **{k: p[k] for k in ("exposed_ms_median",
                                 "pushed_before_backward_share") if k in p},
            **({"staging_ms": {k: _median([t[k] * 1e3 for t in p["staging"]])
                               for k in ("d2h_s", "core_s", "h2d_s")}}
               if p["staging"] else {}))
    log("BERT-Large paths, median of steps 2-4:", json.dumps({
        label: {k: v for k, v in r.items()
                if k not in ("losses", "step_ms", "profile")}
        for label, r in out.items()}))
    return {"bert_large": out, "gpt2_medium": medium}


def llama_phase():
    """Phase 7. Llama1B(flash, bf16), seed-0 weights, batch 4 x seq 2048,
    tokens in [0, 32000) from default_rng(0), lm_loss, AdamW(1e-4, weight
    decay 1e-4): (a) collective make_train_step STEPS steps, one
    evaluation forward (held to plain attention on 256 tokens), one
    profiled step; (a') the same from the same weights with remat=True,
    LLAMA_REMAT_STEPS steps, its losses equal to (a)'s to the bit (the
    kernels are deterministic) with the forward kernel launched twice a
    layer; (b) the plain PS step, LLAMA_PS_STEPS steps on the f32 wire,
    its losses equal to (a)'s to rtol 1e-5, with its D2H / core / H2D
    split."""
    import gc

    import torch

    import byteps_tpu_torch as bps

    os.environ["BYTEPS_PS_MODE"] = "collective"
    bps.init()
    try:
        model, step, batch, losses, times, _, launches, peak_gb = _train(
            "llama1b collective", LLAMA)
        n_params = sum(p.numel() for p in model.parameters())
        eval_launches, err = _evaluate(LLAMA, model, batch, batch[:1, :256])
        launches["fwd"] = eval_launches["fwd"]
        profile = _profile_lm("llama1b collective", step, model, batch,
                              times)
        coll = _summary(LLAMA, losses, times, launches, peak_gb,
                        params=n_params, profile=profile,
                        flash_vs_plain_max_abs_err=err)
        del model, step, batch
        gc.collect()
        torch.cuda.empty_cache()

        model, step, _, r_losses, r_times, _, r_launches, r_peak = _train(
            "llama1b remat", LLAMA, steps=LLAMA_REMAT_STEPS, remat=True)
        if r_losses != losses[:LLAMA_REMAT_STEPS]:
            raise AssertionError(f"llama1b remat losses {r_losses} != "
                                 f"{losses[:LLAMA_REMAT_STEPS]}")
        remat = _summary(LLAMA, r_losses, r_times, r_launches, r_peak)
        del model, step
        gc.collect()
    finally:
        bps.shutdown()
    torch.cuda.empty_cache()

    with _fleet():
        bps.init()
        try:
            model, _, _, p_losses, p_times, staging, p_launches, p_peak = (
                _train("llama1b ps", LLAMA, steps=LLAMA_PS_STEPS))
            del model
            gc.collect()
        finally:
            bps.shutdown()
    torch.cuda.empty_cache()
    _losses_match("llama1b ps", p_losses, losses)
    ps_out = _summary(
        LLAMA, p_losses, p_times, p_launches, p_peak,
        idle_share_vs_collective_card_ms=1.0 - profile["device_ms"]
        / _median(p_times),
        staging_ms={k: _median([t[k] * 1e3 for t in staging])
                    for k in ("d2h_s", "core_s", "h2d_s")},
        wire_bytes_per_step=4 * n_params)
    out = {"collective": coll, "remat": remat, "ps": ps_out}
    log("Llama-1B paths, median of steps 2-n:", json.dumps({
        label: {k: v for k, v in r.items()
                if k not in ("losses", "step_ms", "profile")}
        for label, r in out.items()}))
    return {"llama1b": out}


# --- phase 8: the launcher, checkpoint/resume, callbacks, timeline -----------

LAUNCH_WORKERS, PREEMPT_AFTER, TRACED_STEP = 2, 2, 3
# a fleet that has not ended by then has hung; its workers print every
# thread's stack a minute before
FLEET_TIMEOUT_S = 300
# the in-place check's tensor on worker r holds r + 1; the mean of 1 and 2
INPLACE_MEAN = 1.5


def _sha256(tensors):
    """sha256 over the bytes of ``tensors``, in order."""
    import hashlib

    import torch
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _trace_check(path):
    """What the merged timeline of the traced step holds: the core's push
    and pull spans (under the core's process row) and the three training
    kernels, and whether the spans sit, after the clock shift, inside the
    profiler's time range and after the step's first forward kernel (a
    push waits for its gradient, which waits for the forward)."""
    from byteps_tpu_torch.utils.timeline import _DCN_PID
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if "ts" in e]
    core = [e for e in events if e.get("pid") == _DCN_PID
            and e.get("name") in ("push", "pull")]
    prof = [e for e in events if e.get("pid") != _DCN_PID]
    lo = min(float(e["ts"]) for e in prof)
    hi = max(float(e["ts"]) + float(e.get("dur", 0)) for e in prof)
    kernels = {}
    for name in ("fa_fwd_wgmma_kernel", "fa_bwd_dq_wgmma_kernel",
                 "fa_bwd_dkv_wgmma_kernel"):
        kernels[name] = sorted(float(e["ts"]) for e in events
                               if e.get("cat") == "kernel"
                               and name in e.get("name", ""))
    pushes = sorted(float(e["ts"]) for e in core if e["name"] == "push")
    pulls = [float(e["ts"]) + float(e.get("dur", 0)) for e in core
             if e["name"] == "pull"]
    return {
        "push_spans": len(pushes), "pull_spans": len(pulls),
        "kernel_events": {k: len(v) for k, v in kernels.items()},
        "spans_inside_profile": all(
            lo <= float(e["ts"]) and float(e["ts"]) + float(e.get("dur", 0))
            <= hi for e in core),
        "first_push_after_first_forward_us": (
            pushes[0] - kernels["fa_fwd_wgmma_kernel"][0]
            if pushes and kernels["fa_fwd_wgmma_kernel"] else None),
        "last_pull_after_last_dkv_us": (
            max(pulls) - kernels["fa_bwd_dkv_wgmma_kernel"][-1]
            if pulls and kernels["fa_bwd_dkv_wgmma_kernel"] else None),
    }


def launched_worker(out_dir, preempt_after=0, trace=False):
    """One worker of phase 8, started by the port's launcher (``python
    chip_smoke.py --launched-worker DIR``): GPT2Small(flash) with the
    seed-0 weights on rows [4r, 4r + 4) of phase 3's tokens,
    DistributedOptimizer(AdamW(1e-4, weight decay 1e-4)) on the f32 wire,
    STEPS steps in all, each followed by rank 0's checkpoint of the
    model, the optimizer and the step (keep 2). It resumes from the
    newest checkpoint in DIR/ckpt when there is one. With
    ``preempt_after`` k, rank 0 ends its process (``os._exit``) right
    after checkpointing step k; with ``trace``, rank 0 traces step
    TRACED_STEP through ``Timeline``. It writes what it saw to
    DIR/rank<r>_from<start>.json and never prints the smoke run's result
    lines."""
    import faulthandler

    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.callbacks import (BroadcastGlobalVariablesCallback,
                                            CallbackList,
                                            MetricAverageCallback,
                                            MonitorCallback)
    from byteps_tpu_torch.utils import (Timeline, restore_checkpoint,
                                        save_checkpoint)
    fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")

    faulthandler.dump_traceback_later(FLEET_TIMEOUT_S - 60)
    lm = GPT2
    t_start = time.monotonic()
    me = f"launched worker {os.environ.get('DMLC_WORKER_ID')}"

    def progress(what):
        log(f"{me}: {what} at {time.monotonic() - t_start:.1f} s")
    if trace and os.environ.get("DMLC_WORKER_ID") == "0":
        os.environ.update({
            "BYTEPS_TRACE_ON": "1",
            "BYTEPS_TRACE_DIR": os.path.join(out_dir, "trace"),
            "BYTEPS_TRACE_START_STEP": str(TRACED_STEP - 1),
            "BYTEPS_TRACE_END_STEP": str(TRACED_STEP)})
    bps.init()
    progress("initialised")
    # before anything is pushed: the core's ring then records only the
    # traced step
    timeline = Timeline()
    rank, size = bps.rank(), bps.size()
    if size != LAUNCH_WORKERS:
        raise AssertionError(f"fleet of {size} workers")
    ckpt = os.path.join(out_dir, "ckpt")
    model = lm.make()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)
    t0 = time.perf_counter()
    state, start = restore_checkpoint(
        ckpt, {"model": model.state_dict(), "optimizer": opt.state_dict(),
               "step": 0})
    if start is not None:
        model.load_state_dict(state["model"])
        opt.load_state_dict(state["optimizer"])
        if state["step"] != start:
            raise AssertionError(f"checkpoint step {state['step']} in "
                                 f"step_{start}")
    del state
    restore_s = time.perf_counter() - t0
    progress(f"restored step {start}")
    start = start or 0
    dopt = bps.DistributedOptimizer(opt)
    loop = {"model": model, "optimizer": dopt, "metrics": {}}
    callbacks = CallbackList([BroadcastGlobalVariablesCallback(0),
                              MetricAverageCallback(), MonitorCallback()])
    callbacks.on_train_begin(loop)
    progress("broadcast")

    # the in-place API on the card: declared, then blocking and async
    x = torch.full((1024,), float(rank + 1), device=bps.device())
    y = x.clone()
    bps.declare("inplace", x)
    bps.declare("inplace_async", y)
    if bps.push_pull_inplace_(x, name="inplace") is not x:
        raise AssertionError("push_pull_inplace_ returned another tensor")
    if bps.synchronize(bps.push_pull_async_inplace_(
            y, name="inplace_async")) is not y:
        raise AssertionError("push_pull_async_inplace_ wrote elsewhere")
    inplace = [float(x.min()), float(x.max()), float(y.min()),
               float(y.max())]
    progress(f"in-place {inplace}")

    rows = lm.shape[0] // size
    batch = lm.batch(bps.device())[rows * rank:rows * (rank + 1)]
    rec = {"rank": rank, "start": start, "restore_s": restore_s,
           "grad_bytes": 4 * sum(p.numel() for p in model.parameters()),
           "inplace": inplace, "steps": {}}
    path = os.path.join(out_dir, f"rank{rank}_from{start}.json")

    def write():
        with open(path, "w") as f:
            json.dump(rec, f)
    write()
    for step in range(start + 1, STEPS + 1):
        torch.cuda.synchronize()
        fa.reset_launches()
        t0 = time.perf_counter()
        dopt.zero_grad()
        loss = lm.loss(model, batch)
        loss.backward()
        dopt.step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(fa.LAUNCHES)
        _check_launches(f"launched worker {rank} step {step}", launches,
                        lm.layers, steps=1)
        loop["metrics"] = {"loss": loss.item()}
        callbacks.on_batch_end(step, loop)
        timeline.step()
        t0 = time.perf_counter()
        save_checkpoint(ckpt, {"model": model.state_dict(),
                               "optimizer": opt.state_dict(), "step": step},
                        step, keep=2)
        rec["steps"][step] = {
            "loss": loop["metrics"]["loss"], "ms": step_ms,
            "launches": launches, "save_s": time.perf_counter() - t0,
            "wire_sent_bytes": loop["monitor"]["wire_sent_bytes"],
            "done": time.monotonic()}
        progress(f"step {step} ({step_ms:.0f} ms, loss "
                 f"{loop['metrics']['loss']:.6f}) saved")
        if rank == 0 and step == preempt_after:
            rec["exit"] = time.monotonic()
            write()
            os._exit(3)
        write()
    callbacks.on_epoch_end(0, loop)
    rec["loss_mean"] = loop["metrics"]["loss"]
    moments = [v for _, s in sorted(opt.state_dict()["state"].items())
               for k, v in sorted(s.items()) if k != "step"]
    rec["sha256"] = {"params": _sha256(model.state_dict().values()),
                     "adamw_moments": _sha256(moments)}
    if trace and rank == 0:
        rec["trace"] = _trace_check(os.path.join(
            out_dir, "trace", f"combined_rank{rank}.json"))
    bps.shutdown()
    write()
    progress("done")
    return 0


def _worker_cmd(out_dir, extra):
    return [sys.executable, os.path.join(HERE, "chip_smoke.py"),
            "--launched-worker", out_dir, *extra]


def _launch(label, out_dir, extra, timeout=FLEET_TIMEOUT_S):
    """``python -m byteps_tpu_torch.launcher --local 2 --num-servers 1
    --restarts 1 -- <worker>``, in a session of its own so that every
    process of the fleet goes down with it; returns its exit code, its
    output and its seconds."""
    import signal
    env = dict(os.environ)
    env.update({"PYTHONPATH": HERE + os.pathsep + env.get("PYTHONPATH", ""),
                "PS_HEARTBEAT_INTERVAL": "1", "PS_HEARTBEAT_TIMEOUT": "4",
                "BYTEPS_PS_MODE": "ps",
                # a step's pushes (498 MB) within the push budget: the
                # hook-driven pushes of two workers need it
                # (overlap._TapState.check_credit)
                "BYTEPS_SCHEDULING_CREDIT": str(1 << 30)})
    log_path = os.path.join(out_dir, "launcher.log")
    cmd = [sys.executable, "-m", "byteps_tpu_torch.launcher", "--local",
           str(LAUNCH_WORKERS), "--num-servers", "1", "--restarts", "1",
           "--", *_worker_cmd(out_dir, extra)]
    t0 = time.perf_counter()
    with open(log_path, "w") as out:
        p = subprocess.Popen(cmd, env=env, cwd=HERE, stdout=out,
                             stderr=subprocess.STDOUT,
                             start_new_session=True)
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
    seconds = time.perf_counter() - t0
    with open(log_path) as f:
        text = f.read()
    if rc != 0:
        log(f"--- fleet {label} log ---\n{text[-12000:]}")
        raise AssertionError(f"fleet {label}: launcher exit {rc}")
    return text, seconds


def launch_phase(coll_losses):
    """Phase 8. Two fleets of the port's launcher (scheduler, one server,
    LAUNCH_WORKERS GPT-2 small workers on the card): (U) runs STEPS steps
    uninterrupted and traces step TRACED_STEP on rank 0; (P) loses rank 0
    after checkpointing step PREEMPT_AFTER, the launcher restarts the
    fleet once, and the second life resumes from that checkpoint. Gates:
    every child of both fleets exits 0 in the end; (P) restarted once and
    (U) never; (U) and (P) end with the same sha256 of every parameter
    and AdamW moment on each worker, and the same losses for the steps
    after the preemption; the three training kernels launch 12 times a
    step on each worker; the in-place results are INPLACE_MEAN; both
    workers hold the same metric average; each step sends at least the
    gradients' bytes; the merged timeline holds the core's push and pull
    spans inside the profiler's range and after the step's first forward
    kernel, and the three kernels; the mean of the workers' step-1 losses
    is within 1e-3 relative of phase 3's step-1 loss."""
    import shutil
    tmp = tempfile.mkdtemp(prefix="chip_smoke_launch_")
    try:
        runs = {}
        for label, extra in (("U", ["--trace"]),
                             ("P", ["--preempt-after", str(PREEMPT_AFTER)])):
            d = os.path.join(tmp, label)
            os.makedirs(d)
            text, seconds = _launch(label, d, extra)
            restarted = "restart 1/1" in text
            if restarted != (label == "P"):
                raise AssertionError(f"fleet {label}: restarted "
                                     f"{restarted}:\n{text[-4000:]}")
            recs = {}
            for name in sorted(os.listdir(d)):
                if name.endswith(".json"):
                    with open(os.path.join(d, name)) as f:
                        recs[name[:-5]] = json.load(f)
            runs[label] = {"records": recs, "seconds": seconds}
            log(f"fleet {label}: {seconds:.1f} s, records {sorted(recs)}")
        return _launch_summary(runs, coll_losses)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _launch_summary(runs, coll_losses):
    """The gates of ``launch_phase`` over the workers' records, and what
    the phase reports."""
    u, p = runs["U"]["records"], runs["P"]["records"]
    want = ({f"rank{r}_from0" for r in range(LAUNCH_WORKERS)},
            {f"rank{r}_from{s}" for r in range(LAUNCH_WORKERS)
             for s in (0, PREEMPT_AFTER)})
    if (set(u), set(p)) != want:
        raise AssertionError(f"records U {sorted(u)} P {sorted(p)}")
    out = {"fleet_seconds": {k: r["seconds"] for k, r in runs.items()}}
    for rank in range(LAUNCH_WORKERS):
        whole = u[f"rank{rank}_from0"]
        first, second = p[f"rank{rank}_from0"], p[
            f"rank{rank}_from{PREEMPT_AFTER}"]
        if whole["sha256"] != second["sha256"]:
            raise AssertionError(f"rank {rank}: U {whole['sha256']} != P "
                                 f"{second['sha256']}")
        for s in range(PREEMPT_AFTER + 1, STEPS + 1):
            if whole["steps"][str(s)]["loss"] != second["steps"][str(s)][
                    "loss"]:
                raise AssertionError(f"rank {rank} step {s}: losses U "
                                     f"{whole['steps']} P {second['steps']}")
        for rec in (whole, first, second):
            if rec["inplace"] != [INPLACE_MEAN] * 4:
                raise AssertionError(f"rank {rank}: in-place {rec['inplace']}")
            for s, st in rec["steps"].items():
                if st["wire_sent_bytes"] < rec["grad_bytes"]:
                    raise AssertionError(f"rank {rank} step {s} sent "
                                         f"{st['wire_sent_bytes']} bytes")
    for recs in (u, p):
        ends = [r for k, r in recs.items() if "loss_mean" in r]
        if len({r["loss_mean"] for r in ends}) != 1 or len(
                {json.dumps(r["sha256"]) for r in ends}) != 1:
            raise AssertionError(f"workers disagree: {ends}")
    step1 = sum(u[f"rank{r}_from0"]["steps"]["1"]["loss"]
                for r in range(LAUNCH_WORKERS)) / LAUNCH_WORKERS
    if not abs(step1 - coll_losses[0]) <= 1e-3 * abs(coll_losses[0]):
        raise AssertionError(f"step-1 loss mean {step1} vs phase 3 "
                             f"{coll_losses[0]}")
    trace = u["rank0_from0"].get("trace")
    if not (trace and trace["push_spans"] and trace["pull_spans"]
            and trace["spans_inside_profile"]
            and trace["first_push_after_first_forward_us"] > 0
            and trace["last_pull_after_last_dkv_us"] > 0
            and all(trace["kernel_events"].values())):
        raise AssertionError(f"merged timeline: {trace}")
    w0 = p["rank0_from0"]
    out.update({
        "step1_loss_mean": step1, "phase3_losses": coll_losses,
        "losses": {label: {k: {s: st["loss"] for s, st in r["steps"].items()}
                           for k, r in recs.items()}
                   for label, recs in (("U", u), ("P", p))},
        "step_ms": {label: {k: [st["ms"] for st in r["steps"].values()]
                            for k, r in recs.items()}
                    for label, recs in (("U", u), ("P", p))},
        "save_s": [st["save_s"] for st in u["rank0_from0"]["steps"].values()],
        "restore_s": {k: r["restore_s"] for k, r in p.items()
                      if r["start"]},
        "exit_to_first_step_s": p[f"rank0_from{PREEMPT_AFTER}"]["steps"][
            str(PREEMPT_AFTER + 1)]["done"] - w0["exit"],
        "wire_sent_bytes": [st["wire_sent_bytes"]
                            for st in u["rank0_from0"]["steps"].values()],
        "sha256": u["rank0_from0"]["sha256"],
        "trace": trace,
        "launches": {k: sum(st["launches"][k] for r in u.values()
                            for st in r["steps"].values())
                     for k in ("fwd_lse", "fwd", "bwd_dq", "bwd_dkv")},
    })
    log("launched fleets:", json.dumps({k: v for k, v in out.items()
                                        if k not in ("losses", "step_ms")}))
    return out


# --- phase 9: sequence parallelism and the int8 transport on one card --------

SP_RANKS, SP_TIMEOUT_S = 2, 600
# Llama-1B over one row of SP_SEQ tokens; the ring check at depth
# SP_RING_LAYERS
SP_SEQ, SP_RING_LAYERS = 8192, 2
# bf16's rounding unit: the share by which a bf16 model's loss may move
# when its attention runs in another arithmetic (ring's f32 blocks)
BF16_UNIT = 2.0 ** -8
# (c): the relative L2 distance allowed between ring's and Ulysses +
# flash's gradients. The two differ in the attention's arithmetic (f32
# blocks against bf16 tiles), 1.1-1.2 % on the card; a backward that
# routes a gradient to the wrong rank is far beyond it (PERF.md, PR 8,
# tools/sp_gate_controls.py).
RING_GRAD_REL_L2 = 0.05


def _llama_long(attn_impl="flash", sp_group=None, **kw):
    import torch

    from byteps_tpu_torch.models import Llama1B
    return Llama1B(attn_impl=attn_impl, dtype=torch.bfloat16,
                   sp_group=sp_group,
                   generator=torch.Generator().manual_seed(0), **kw)


def _long_tokens(device):
    return _tokens(device, 1, SP_SEQ, LLAMA.vocab)


# Phase 9 (a)'s model: Llama-1B over one row of SP_SEQ tokens
LLAMA_LONG = LLAMA._replace(name="llama1b_8192", make=_llama_long,
                            batch=_long_tokens, shape=(1, SP_SEQ))


def _free():
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _int8_staged_bytes(n, k, block=256):
    """Bytes one member of a k-member gloo group stages through host
    memory, each way counted, for one quantized_all_reduce of n f32
    values padded to m (a multiple of k blocks), int8 and one f32 scale a
    block: the reduce-scatter's all-to-all (m + 4m/block in, the same
    out), the all-gather (1/k of that in, all of it out). An exact f32
    all-reduce stages 8m."""
    m = n + (-n) % (k * block)
    wire = m + m // block * 4
    return 3 * wire + wire // k


def _sp_llama(sp, rank):
    """(b): Llama1B(flash) with the seed-0 weights and ``sp_group``, rank
    r holding tokens [r S/2, (r + 1) S/2) of (a)'s sequence (positions
    global by default): an evaluation forward at the seed-0 weights, then
    STEPS make_train_step steps of sp_lm_loss with (a)'s AdamW, the
    gradients averaged over the sp group. The flash wrapper's inputs are
    recorded (the inner call's shape)."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import sp_lm_loss
    from byteps_tpu_torch.parallel import _collectives as C
    from byteps_tpu_torch.training import make_train_step
    fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")

    bps.init(group=sp)
    local = SP_SEQ // SP_RANKS
    tokens = _long_tokens("cuda")[:, rank * local:(rank + 1) * local]
    model = _llama_long("flash", sp_group=sp)
    shapes, real = set(), fa.flash_fwd

    def spy(q, *a, **kw):
        shapes.add(tuple(q.shape))
        return real(q, *a, **kw)
    fa.flash_fwd = spy
    try:
        fa.reset_launches()
        with torch.no_grad():
            logits = model(tokens)
        torch.cuda.synchronize()
        eval_launches = dict(fa.LAUNCHES)
        if (tuple(logits.shape) != (1, local, LLAMA.vocab)
                or not bool(torch.isfinite(logits).all())):
            raise AssertionError("sp evaluation logits: bad shape or values")
        del logits
        opt = torch.optim.AdamW(model.parameters(), lr=1e-4,
                                weight_decay=1e-4)
        step = make_train_step(
            lambda m, t: sp_lm_loss(m(t), t, sp), opt)
        losses, times = [], []
        torch.cuda.synchronize()
        fa.reset_launches()
        C.reset_bytes()
        for _ in range(STEPS):
            t0 = time.perf_counter()
            loss = step(model, tokens)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
        launches, moved = dict(fa.LAUNCHES), dict(C.BYTES)
    finally:
        fa.flash_fwd = real
    out = {"losses": losses, "step_ms": times, "launches": launches,
           "eval_launches": eval_launches,
           "flash_shapes": sorted(shapes),
           "bytes_per_step": {k: v / STEPS for k, v in moved.items()},
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del model, opt, step
    bps.shutdown()
    _free()
    return out


def _sp_ring_check(sp, rank):
    """(c): the same configuration at depth SP_RING_LAYERS, one forward
    and backward of sp_lm_loss under ``ring`` (plain f32 block attention,
    K/V round the ring) and under (b)'s Ulysses + flash, from the same
    seed-0 weights. Returns what (c)'s gates read."""
    import torch

    from byteps_tpu_torch.models import sp_lm_loss
    from byteps_tpu_torch.parallel import _collectives as C

    local = SP_SEQ // SP_RANKS
    tokens = _long_tokens("cuda")[:, rank * local:(rank + 1) * local]
    runs = {}
    for impl in ("ring", "flash"):
        model = _llama_long(impl, sp_group=sp, num_layers=SP_RING_LAYERS)
        C.reset_bytes()
        t0 = time.perf_counter()
        logits = model(tokens)
        loss = sp_lm_loss(logits, tokens, sp)
        loss.backward()
        torch.cuda.synchronize()
        runs[impl] = {
            "ms": (time.perf_counter() - t0) * 1e3, "loss": loss.item(),
            "logits": logits.detach(), "bytes": dict(C.BYTES),
            "grad": torch.cat([p.grad.reshape(-1).float()
                               for p in model.parameters()]),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        del model, logits, loss
        _free()
    ring, flash = runs["ring"], runs["flash"]
    out = {
        "losses": {k: r["loss"] for k, r in runs.items()},
        "ms": {k: r["ms"] for k, r in runs.items()},
        "bytes": {k: r["bytes"] for k, r in runs.items()},
        "peak_memory_gb": {k: r["peak_memory_gb"] for k, r in runs.items()},
        "logits_max_abs_err": (ring["logits"] - flash["logits"]).abs()
        .max().item(),
        "grad_rel_l2": ((ring["grad"] - flash["grad"]).norm()
                        / flash["grad"].norm()).item()}
    del runs, ring, flash
    _free()
    return out


def _int8_bound(grads, exact, group, block=256):
    """Element-wise bound of |tree_quantized_all_reduce - exact average|
    over ``group`` (k members, one quantized level, blocks of ``block``),
    derived from the quantiser: each member rounds its value to the
    nearest of 255 steps of its block's max / 127, an error of at most
    half a step, and the stage-1 sum is averaged: sum_r s_r / (2k). The
    averaged shard is quantized once more for the all-gather, half a step
    of its own block's max, which is at most the exact average's block max
    plus the stage-1 error: (max|exact| + e1) / 254. The f32 products,
    sum and division round a few times at 2^-24 of values at most that
    max: 1e-6 of it. A block of zeros, which the quantiser keeps exact,
    gets the smallest normal f32 as its limit."""
    import torch

    from byteps_tpu_torch.parallel import tree_all_reduce
    from byteps_tpu_torch.parallel._collectives import group_size

    k = group_size(group)
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    want = torch.cat([g.reshape(-1).float() for g in exact])
    n = flat.numel()
    pad = (-n) % (k * block)
    flat = torch.cat([flat, flat.new_zeros(pad)]).reshape(-1, block)
    want = torch.cat([want, want.new_zeros(pad)]).reshape(-1, block)
    steps = flat.abs().amax(dim=1) / 127.0
    e1 = tree_all_reduce(steps, ici_group=group, average=False) / (2 * k)
    ymax = want.abs().amax(dim=1) + e1
    bound = e1 + ymax / 254.0 + 1e-6 * ymax + torch.finfo(torch.float32).tiny
    return bound[:, None].expand(-1, block).reshape(-1)[:n]


def _sp_int8(sp, rank):
    """(d): GPT2Small(flash) with the seed-0 weights on rows [4r, 4r + 4)
    of phase 3's batch, the pair in collective mode. One
    tree_quantized_all_reduce of the gradients at the seed-0 weights
    against the exact f32 average (``_int8_bound``); then
    make_train_step(compression=int8) with the pair as the ici group,
    STEPS steps, and the same with int8_dcn and the pair as the dcn
    group."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.compression import Compression
    from byteps_tpu_torch.parallel import (Mesh, tree_all_reduce,
                                           tree_quantized_all_reduce)
    from byteps_tpu_torch.parallel import _collectives as C
    from byteps_tpu_torch.training import make_train_step
    fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")

    half = BATCH // SP_RANKS
    tokens = _tokens("cuda")[rank * half:(rank + 1) * half]
    out = {}
    # the pair as the ici level, then as the dcn level
    for name, shape in (("int8", (1, SP_RANKS)), ("int8_dcn", (SP_RANKS, 1))):
        bps.init(mesh=Mesh(shape, ("dcn", "ici")))
        model = _model()
        out["n_params"] = sum(p.numel() for p in model.parameters())
        if name == "int8":
            _loss_fn(model, tokens).backward()
            grads = [p.grad.detach().clone() for p in model.parameters()]
            model.zero_grad(set_to_none=True)
            got = tree_quantized_all_reduce(grads, ici_group=sp)
            exact = tree_all_reduce(grads, ici_group=sp)
            bound = _int8_bound(grads, exact, sp)
            err = torch.cat([(a - b).reshape(-1).abs().float()
                             for a, b in zip(got, exact)])
            out["quantized_err_over_bound"] = (err / bound).max().item()
            out["quantized_max_abs_err"] = err.max().item()
            del grads, got, exact, bound, err
        opt = torch.optim.AdamW(model.parameters(), lr=1e-4,
                                weight_decay=1e-4)
        step = make_train_step(_loss_fn, opt,
                               compression=getattr(Compression, name))
        losses, times = [], []
        torch.cuda.synchronize()
        fa.reset_launches()
        C.reset_bytes()
        for _ in range(STEPS):
            t0 = time.perf_counter()
            loss = step(model, tokens)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
        out[name] = {"losses": losses, "step_ms": times,
                     "launches": dict(fa.LAUNCHES),
                     "bytes_per_step": {k: v / STEPS
                                        for k, v in C.BYTES.items()}}
        del model, opt, step
        bps.shutdown()
        _free()
    return out


def sp_worker(out_dir, rank, port):
    """One of phase 9's two processes (``python chip_smoke.py --sp-worker
    DIR --rank R --port P``): both on cuda:0 in a gloo group (NCCL refuses
    two ranks on one device), which the port's collectives stage through
    host memory. Runs (b), (c) and (d) and writes DIR/rank<r>.json."""
    import datetime

    import torch
    import torch.distributed as dist

    from byteps_tpu_torch.parallel import Mesh

    torch.cuda.set_device(0)
    os.environ["BYTEPS_PS_MODE"] = "collective"
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=SP_RANKS,
        timeout=datetime.timedelta(seconds=SP_TIMEOUT_S))
    try:
        sp = Mesh((SP_RANKS,), ("sp",)).group("sp")
        t0 = time.perf_counter()
        rec = {"b": _sp_llama(sp, rank)}
        log(f"sp worker {rank}: (b) done at {time.perf_counter() - t0:.1f} s")
        rec["c"] = _sp_ring_check(sp, rank)
        log(f"sp worker {rank}: (c) done at {time.perf_counter() - t0:.1f} s")
        rec["d"] = _sp_int8(sp, rank)
        log(f"sp worker {rank}: (d) done at {time.perf_counter() - t0:.1f} s")
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    return 0


def _run_sp_workers():
    """Start both sp workers (``python chip_smoke.py --sp-worker``) in a
    session of their own, wait for both, kill whatever is left; returns
    their records."""
    import shutil
    import signal
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sp_")
    try:
        env = dict(os.environ)
        env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
        port = _free_port()
        procs = []
        for rank in range(SP_RANKS):
            out = open(os.path.join(tmp, f"worker{rank}.log"), "w")
            procs.append((out, subprocess.Popen(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                 "--sp-worker", tmp, "--rank", str(rank), "--port",
                 str(port)], env=env, cwd=HERE, stdout=out,
                stderr=subprocess.STDOUT, start_new_session=True)))
        deadline = time.monotonic() + SP_TIMEOUT_S
        rcs = []
        for out, p in procs:
            try:
                rcs.append(p.wait(timeout=max(1.0, deadline
                                              - time.monotonic())))
            except subprocess.TimeoutExpired:
                rcs.append(None)
        for out, p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
            out.close()
        for rank, (out, _) in enumerate(procs):
            with open(out.name) as f:
                text = f.read()
            log(f"--- sp worker {rank} (exit {rcs[rank]}) ---\n"
                + text[-6000 if rcs[rank] != 0 else -600:])
        if rcs != [0] * SP_RANKS:
            raise AssertionError(f"sp workers exited {rcs}")
        recs = []
        for rank in range(SP_RANKS):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                recs.append(json.load(f))
        return recs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _nccl_never_stages():
    """A one-process NCCL group on the card: the port's collectives run it
    in place, with no byte staged through host memory. Returns the staged
    bytes (0)."""
    import torch
    import torch.distributed as dist

    from byteps_tpu_torch.parallel import _collectives as C

    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        x = torch.ones(1024, device="cuda")
        C.reset_bytes()
        if C.stages(dist.group.WORLD, x):
            raise AssertionError("an NCCL group would stage through host")
        C.all_reduce_(x, dist.group.WORLD)
        torch.cuda.synchronize()
        if C.BYTES["staged"] != 0 or not bool((x == 1).all()):
            raise AssertionError(f"NCCL all_reduce staged "
                                 f"{C.BYTES['staged']} bytes")
        return C.BYTES["staged"]
    finally:
        dist.destroy_process_group()


def sp_phase(coll_losses):
    """Phase 9. (a) Llama-1B (flash, bf16, seed-0 weights, f32 parameters
    and (a)'s AdamW as phase 7's) over one row of SP_SEQ tokens from
    default_rng(0), STEPS collective steps in this process, freed before
    (b). Then two processes on the card in a gloo group, whose
    collectives the port stages through host memory (``sp_worker``): (b)
    the same model and tokens under Ulysses + flash over the pair, (c)
    ring against (b)'s configuration at depth 2, (d) GPT-2 small through
    the int8 transport. Gates, each written before the run that first
    read it:
    - (b) on each rank: the step-1 loss equal to (a)'s to rtol 1e-5 (the
      logits are (a)'s; only the f32 mean's order differs), the later
      ones within ``_losses_match``'s bf16 bound; #1, #3 and #4 launched
      22 times a step and #2 never in training; the evaluation forward
      launches #2 22 times and nothing else; every flash call at [1,
      seq, heads / 2, head dim];
    - (c): ring and Ulysses + flash logits within 0.1 (``_evaluate``'s
      bound for flash against plain attention), losses within BF16_UNIT,
      gradients within RING_GRAD_REL_L2 (relative L2), K/V sent round
      the ring;
    - (d): the step-1 loss (the mean over the pair) equal to phase 3's to
      rtol 1e-5, the quantized all-reduce within ``_int8_bound`` of the
      exact average, int8_dcn's losses equal to int8's to the bit (one
      quantized level either way), 12 launches a step, and each step
      staging exactly the int8 transport's bytes (``_int8_staged_bytes``)
      plus the loss mean's 8;
    - a one-process NCCL group stages nothing."""
    import torch

    import byteps_tpu_torch as bps

    lm = LLAMA_LONG
    os.environ["BYTEPS_PS_MODE"] = "collective"
    bps.init()
    try:
        model, step, _, losses, times, _, launches, peak_gb = _train(
            lm.name, lm)
        ref = _summary(lm, losses, times, launches, peak_gb)
        heads, head_dim = model.layers[0].attn.q.kernel.shape[-2:]
        del model, step
    finally:
        bps.shutdown()
    _free()
    nccl_staged = _nccl_never_stages()
    held_gb = {"allocated": torch.cuda.memory_allocated() / 1e9,
               "reserved": torch.cuda.memory_reserved() / 1e9}
    log("before phase 9's processes this one holds (GB):",
        json.dumps(held_gb))

    recs = _run_sp_workers()
    for rank, rec in enumerate(recs):
        b, c, d = rec["b"], rec["c"], rec["d"]
        label = f"llama1b_sp2 rank {rank}"
        _losses_match(label, b["losses"], losses, wire="bfloat16")
        _check_launches(label, b["launches"], lm.layers, STEPS)
        _check_eval_launches(label, b["eval_launches"], lm.layers)
        if b["flash_shapes"] != [[1, SP_SEQ, heads // SP_RANKS, head_dim]]:
            raise AssertionError(f"{label} flash shapes {b['flash_shapes']}")
        ring_loss, flash_loss = c["losses"]["ring"], c["losses"]["flash"]
        if not (c["logits_max_abs_err"] <= 0.1
                and c["grad_rel_l2"] <= RING_GRAD_REL_L2
                and abs(ring_loss - flash_loss) <= BF16_UNIT
                * abs(flash_loss)
                and c["bytes"]["ring"]["ppermute"] > 0):
            raise AssertionError(f"ring check rank {rank}: {c}")
        if not abs(d["int8"]["losses"][0] - coll_losses[0]) <= 1e-5 * abs(
                coll_losses[0]):
            raise AssertionError(f"int8 step-1 loss {d['int8']['losses']} "
                                 f"vs phase 3 {coll_losses[0]}")
        if d["int8_dcn"]["losses"] != d["int8"]["losses"]:
            raise AssertionError(f"int8_dcn {d['int8_dcn']['losses']} != "
                                 f"int8 {d['int8']['losses']}")
        if not d["quantized_err_over_bound"] <= 1.0:
            raise AssertionError(f"quantized all-reduce rank {rank}: "
                                 f"{d['quantized_err_over_bound']} of its "
                                 f"bound")
        staged = _int8_staged_bytes(d["n_params"], SP_RANKS) + 8
        for name in ("int8", "int8_dcn"):
            _check_launches(f"{name} rank {rank}", d[name]["launches"])
            if d[name]["bytes_per_step"]["staged"] != staged:
                raise AssertionError(
                    f"{name} rank {rank} staged "
                    f"{d[name]['bytes_per_step']['staged']} bytes a step, "
                    f"the int8 transport {staged}")
    out = {"llama1b_8192": ref, "nccl_staged_bytes": nccl_staged,
           "main_process_held_gb": held_gb, "ranks": recs}
    log("phase 9 (sequence parallel, int8):", json.dumps({
        "a": {k: ref[k] for k in ("losses", "median_step_ms",
                                  "peak_memory_gb")},
        "ranks": recs}))
    return out


# --- main ---------------------------------------------------------------------

REPLACES = {
    # bf16/f16 on the tensor cores; f32 on the FMA kernel
    "fwd_lse": ("fa_fwd_wgmma_kernel<T,D,true> | "
                "fa_fwd_kernel<float,D,true>",
                "byteps_tpu/ops/flash_attention.py:253"),
    "fwd": ("fa_fwd_wgmma_kernel<T,D,false> | "
            "fa_fwd_kernel<float,D,false>",
            "byteps_tpu/ops/flash_attention.py:277"),
    "bwd_dq": ("fa_bwd_dq_wgmma_kernel<T,D> | "
               "fa_bwd_dq_kernel<float,D>",
               "byteps_tpu/ops/flash_attention.py:463"),
    "bwd_dkv": ("fa_bwd_dkv_wgmma_kernel<T,D> | "
                "fa_bwd_dkv_kernel<float,D>",
                "byteps_tpu/ops/flash_attention.py:487"),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; this smoke run needs a GPU")
        return 2
    sys.path.insert(0, HERE)
    import byteps_tpu_torch  # noqa: F401 (fails outside a checkout)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log("device:", smi, "| torch", torch.__version__, "cuda",
        torch.version.cuda)

    build_s = build_all()
    sass = tensor_core_sass()
    errors, timing = kernel_phase()
    coll_losses, coll_times, coll_launches, profile = collective_phase()
    # phase 9 runs here, while this process holds little of the card: its
    # two processes need 27 GB each, and after phases 4-8 this process
    # kept enough that they ran out of memory
    sp = sp_phase(coll_losses)
    alone, paths = ps_phase(coll_losses)
    plain = paths.pop("ps")
    images = resnet_phase()
    encoder = bert_phase()
    llama = llama_phase()
    launched = launch_phase(coll_losses)
    torch.cuda.empty_cache()
    held_gb = {"allocated": torch.cuda.memory_allocated() / 1e9,
               "reserved": torch.cuda.memory_reserved() / 1e9}
    log("after phase 8 this process holds (GB):", json.dumps(held_gb))

    def staging_ms(run):
        return {"step": _median(run["step_ms"]),
                **{k: _median([s[k] * 1e3 for s in run["staging"]])
                   for k in ("d2h_s", "core_s", "h2d_s")}}
    summary = {
        "build_s": build_s,
        "tensor_core_kernels": sass,
        "collective": {"losses": coll_losses, "step_ms": coll_times,
                       "median_step_ms": _median(coll_times),
                       "launches": coll_launches, "profile": profile},
        "ps": {**{k: v for k, v in alone.items() if k != "staging"},
               "median_step_ms": _median(alone["step_ms"]),
               "staging_ms": [{k: v * 1e3 for k, v in s.items()}
                              for s in alone["staging"]]},
        "ps_in_turns": {**{k: v for k, v in plain.items()
                           if k not in ("staging", "steps")},
                        "staging_ms": [{k: v * 1e3 for k, v in s.items()}
                                       for s in plain["staging"]]},
        "ps_overlap": paths,
        "ps_paths_median_ms": {
            "plain_alone": staging_ms(alone),
            "plain": staging_ms(plain),
            **{label: {"step": o["median_step_ms"],
                       "exposed": o["exposed_ms_median"],
                       "pushed_before_backward_share":
                           o["pushed_before_backward_share"]}
               for label, o in paths.items()}},
        **images,
        **encoder,
        **llama,
        "launched_fleets": launched,
        "sequence_parallel": sp,
        "memory_held_after_phase8_gb": held_gb,
        "sdpa_fwd_bwd_ms": {case: timing[case]["sdpa_fwd_bwd_ms"]
                            for case in TIMED},
        "bwd_pair": {case: timing[case]["bwd_pair"] for case in TIMED},
        "kernel_errors": errors,
        "kernel_readings": timing["readings"],
    }
    log("PS paths, median of steps 2-4 (ms; plain_alone: the plain step "
        "before the others, plain: in turns with them; their D2H / core / "
        "H2D):",
        json.dumps(summary["ps_paths_median_ms"]))
    log("ResNet-50 paths, median of steps 2-4:", json.dumps({
        label: {k: v for k, v in r.items()
                if k not in ("losses", "step_ms", "profile")}
        for label, r in images["resnet50"].items()}))
    print(json.dumps(summary))
    # launches on each main path (its collective run: training steps, and
    # for fwd its evaluation forward)
    by_path = {"gpt2_small": coll_launches,
               "bert_large": encoder["bert_large"]["collective"]["launches"],
               "gpt2_medium": encoder["gpt2_medium"]["launches"],
               "llama1b": llama["llama1b"]["collective"]["launches"],
               "llama1b_remat": llama["llama1b"]["remat"]["launches"],
               "launched_fleet_u": launched["launches"],
               "llama1b_8192": sp["llama1b_8192"]["launches"],
               # rank 0 of the two SP processes: training steps, and for
               # fwd its evaluation forward
               "llama1b_sp2": {**sp["ranks"][0]["b"]["launches"],
                               "fwd": sp["ranks"][0]["b"]["eval_launches"][
                                   "fwd"]},
               "gpt2_int8_rank0": sp["ranks"][0]["d"]["int8"]["launches"]}
    kernels = []
    for name, (fn, replaces) in REPLACES.items():
        kernels.append({
            "name": f"flash_attention.{name} ({fn})", "route": "cuda",
            "source": "byteps_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces, "launches": coll_launches[name],
            "max_abs_err": errors[name]["gpt2"], **timing["gpt2"][name],
            "launches_by_path": {p: n[name] for p, n in by_path.items()},
            "shapes": {case: {"max_abs_err": errors[name][case],
                              **timing[case][name]}
                       for case in TIMED if case != "gpt2"}})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _worker_main(argv) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="chip_smoke.py --launched-worker")
    p.add_argument("--launched-worker", metavar="DIR")
    p.add_argument("--preempt-after", type=int, default=0)
    p.add_argument("--trace", action="store_true")
    p.add_argument("--sp-worker", metavar="DIR")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--port", type=int, default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    if args.sp_worker:
        return sp_worker(args.sp_worker, args.rank, args.port)
    return launched_worker(args.launched_worker, args.preempt_after,
                           args.trace)


if __name__ == "__main__":
    if {"--launched-worker", "--sp-worker"} & set(sys.argv[1:]):
        sys.exit(_worker_main(sys.argv[1:]))
    sys.exit(main())
