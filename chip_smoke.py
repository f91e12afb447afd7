#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (byteps_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. build: the flash-attention kernels (nvcc, sm_90a) and the C++ PS core
   (g++), both from this checkout's sources, in parallel, into
   build/byteps_tpu_torch/; the SASS of each instantiation of the
   tensor-core kernels (bf16/f16 and f32 forward, dQ, dK/dV; in f32 three
   TF32 products a product) must hold HGMMA (wgmma) instructions;
2. kernels: each of the four CUDA kernels against its plain PyTorch
   version on the card, at the attention shapes of the main paths (GPT-2
   small: b 8, s 512, h 12, d 64, bf16, causal, and the same in f32;
   BERT-Large: b 32, s 128, h 16, d 64, bf16, non-causal; Llama-1B: b 4,
   s 2048, h 32, d 64, bf16, causal; GPT-2 medium: b 8, s 512, h 16, d
   64, bf16, causal), on f32 cases (unaligned s 600, rectangular causal
   100 x 260, sliding window 64 at s 300) and on the same shape classes
   in bf16 and f16 (plus non-causal 96 x 96); at the main paths' shapes
   each timed beside its plain version, PyTorch's
   scaled_dot_product_attention (in f32 its memory-efficient backend,
   pinned), and its bound (device time from CUDA graph replays, the
   kernels and SDPA's forward and backward in turns over 5 windows);
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
   (b)'s shape too;
10. (run right after phase 9) tensor, pipeline and expert parallelism,
   ZeRO and the dry run (see ``par_phase``), on two processes in a gloo
   group as phase 9's, each held to a one-process run made first in
   this process: (a) GPT-2 medium (flash, bf16, seed-0 weights) over 4 x
   1024 tokens with TP = 2 (``tp_attention`` around the flash kernels at
   [4, 1024, 8, 64], ``tp_mlp``), two forward and backward passes and an
   evaluation forward, against the dense model; (b) its 24 layers as two
   stages of 12, M = 4 microbatches of [1, 1024], through
   ``pipeline_1f1b`` and ``gpipe``, against the same layers run
   microbatch by microbatch; (c) 3 AdamW steps of
   ``make_zero_train_step`` against ``make_train_step``, rows [4r, 4r +
   4) of 8 x 1024 on rank r; (d) the MoE layer at Switch-Base-8's width
   (d 768, d_ff 3072, 8 experts) with EP = 2, 4096 tokens a rank, top-1
   (capacity factor 1.25) and top-2 (2.5), against the dense layer; (e)
   ``dryrun_multichip(2)``. The kernel phase checks and times the
   kernels at (a)'s and (b)'s shapes too;
11. (run right after phase 10) multi-GPU-per-host PS (see
   ``local_ps_phase``): a scheduler, one server and two hosts, each the
   port's launcher with --workers-per-host 2 (python -m
   byteps_tpu_torch.launcher --workers-per-host 2 -- python chip_smoke.py
   --local-ps-worker DIR --port P), all four processes on cuda:0, each
   host's pair in a gloo group of its own sharing host staging, one core
   client a host (local rank 0's): GPT-2 small (flash, seed-0 weights) on
   rows [2r, 2r + 2) of phase 3's tokens for global rank r, 2 steps each
   of the plain step, the overlapped step with the f32 and the bf16
   wire, the hook-driven buckets and the DistributedOptimizer loop, then
   an evaluation forward, held to one process that combines the four
   ranks' gradients in the fleet's order: equal to the bit on the f32
   wire. The kernel phase checks and times the kernels at a rank's
   shape ([2, 512, 12, 64]) too;
12. (run right after phase 11) GPT-2 medium under the C core's codecs
   (BASELINE config 3, see ``codec_phase``): full width, 12 of its 24
   layers, seed-0 weights, 8 x 512 tokens, AdamW with a StepLR, one worker and
   one server a run, each run a fleet of its own with its
   BYTEPS_COMPRESSOR: (a) no codec, the plain step on the f32 and the
   bf16 wire; (b) onebit + EF through the plain step, the overlapped and
   bucketed steps and DistributedOptimizer(named_parameters) in turns;
   (c) topk + EF at the core's default k; (d) onebit + EF on the bf16
   wire. Wire bytes each way (the client's van counters), the D2H / core
   / H2D split, step times, losses and launches; (b) and (d) must cut
   both legs more than 8x, (c) the push leg more than 2x, the step-1
   losses must equal (a)'s to the bit, the later ones stay within
   ``_codec_loss_bounds``, and (b)'s four paths equal each other to the
   bit. The kernel phase checks and times the kernels at GPT-2 medium's
   shape ([8, 512, 16, 64]) too;
13. (run right after phase 12) GPT-2 small trained in f32 (see
   ``f32_phase``): GPT2Small(dtype=float32, attn_impl="flash"), seed-0
   weights, phase 3's tokens, 3 collective AdamW steps through the f32
   kernels (the forward, dQ and dK/dV on the tensor cores as three TF32
   products), held to the same weights under plain attention
   in f32 (step 1's loss and the evaluation logits, within a bound from
   limit()'s f32 terms), then a profiled step.

Stdout ends with the kernels line, the card's name and power limit, and
{"ok": true, "device": {...}}. Exits non-zero, with no result, when CUDA
is not available or any phase fails.
"""

from __future__ import annotations

import collections
import copy
import contextlib
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS = 4
SEQ, BATCH = 512, 8
# H100 SXM published peaks (dense): HBM bytes/s and matrix-product
# operations/s. bf16/fp16 on the tensor cores. f32: the least time for
# products held to f32 accuracy is three TF32 products a product (hi*hi +
# hi*lo + lo*hi, each operand split into two TF32 halves) at the 495
# TFLOP/s TF32 rate, which beats the 67 TFLOP/s of f32 FMAs outside the
# tensor cores; one TF32 product alone keeps 11 bits and is not f32.
HBM_BPS = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 495e12 / 3}


_T0 = time.perf_counter()


def log(*a):
    """A line on stderr, behind the seconds since this process started
    (where each phase's time goes)."""
    print(f"[{time.perf_counter() - _T0:7.1f} s]", *a, file=sys.stderr,
          flush=True)


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
    SASS, by cuobjdump) of each instantiation of the tensor-core kernels:
    the forward with and without lse, dQ and dK/dV in bf16/f16 and in f32
    (three TF32 products); raises if one has no HGMMA, i.e. does not run
    on the tensor cores."""
    import re

    from byteps_tpu_torch.ops import _cuda_lib
    with open(os.path.join(_cuda_lib.BUILD_DIR,
                           "flash_attention.nvcc.log")) as f:
        report = f.read()
    kernels = {}
    for m in re.finditer(
            r"Compiling entry function "
            r"'(\w*fa_(?:fwd|bwd_dq|bwd_dkv)_(?:wgmma|tf32)_kernel\w*)'.*?"
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
        m = re.search(r"(fa_\w+?)_(wgmma|tf32)_kernelI(\w*?)Li(\d+)E"
                      r"(?:Lb([01])E)?", fn)
        dtype = ("float32" if m.group(2) == "tf32" else
                 "bfloat16" if "bfloat16" in m.group(3) else "float16")
        lse = f" lse={m.group(5)}" if m.group(5) else ""
        named[f"{m.group(1)}_{m.group(2)} {dtype} d{m.group(4)}{lse}"] = v
    # 3 dtypes x 4 head dims x (forward with and without lse, dQ, dK/dV)
    f32 = sum(k.split()[1] == "float32" for k in named)
    if (len(named) != 48 or f32 != 16
            or not all(v["hgmma"] > 0 for v in named.values())):
        raise AssertionError(f"tensor-core kernels: expected 32 bf16/f16 "
                             f"and 16 f32 instantiations with HGMMA, got "
                             f"{named}")
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


def _ops_per_pair(name):
    """Matrix-product operations per live (query, key) pair and head-dim
    element that the function needs: the forward's S and P V (2 + 2),
    dQ's S, dP and dS K (6), dK/dV's S^T, dP^T, dS^T Q and P^T dO (8), in
    every dtype (the bf16/f16 kernel's second P^T dO, p split into two
    16-bit halves, is work it adds, not work the function needs)."""
    return {"fwd_lse": 4, "fwd": 4, "bwd_dq": 6, "bwd_dkv": 8}[name]


def _bound_ms(name, b, h, s_q, s_k, d, elem, causal, window, dtype):
    """Least time on the card: bytes read once and written once at the HBM
    rate against the matrix-product operations at the peak of the dtype
    (exp and the rest are not counted)."""
    q_bytes, kv_bytes = b * s_q * h * d * elem, b * s_k * h * d * elem
    row_bytes = b * h * s_q * 4  # one f32 per query row (lse, D)
    ops = _ops_per_pair(name) * d * b * h * _live_pairs(
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
    # GPT-2 medium under TP over 2 ranks (phase 10 (a)): half the heads
    ("tp_gpt2m", 4, 1024, 1024, 8, 64, "bfloat16", True, None),
    # GPT-2 medium's pipeline stages (phase 10 (b)): one microbatch row
    ("pp_gpt2m", 1, 1024, 1024, 16, 64, "bfloat16", True, None),
    # GPT-2 small on each rank of phase 11's fleet: its 2 rows of the 8
    ("gpt2_local_ps", 2, SEQ, SEQ, 12, 64, "bfloat16", True, None),
    # GPT-2 medium's data-parallel step (phases 6 and 12)
    ("gpt2_medium", BATCH, SEQ, SEQ, 16, 64, "bfloat16", True, None),
    # GPT-2 small in f32 (phase 13)
    ("gpt2_f32", BATCH, SEQ, SEQ, 12, 64, "float32", True, None),
    # f32 on every shape class
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
TIMED = ("gpt2", "bert_large", "llama1b", "ulysses_8192", "tp_gpt2m",
         "pp_gpt2m", "gpt2_local_ps", "gpt2_medium", "gpt2_f32")


def _sdpa_backend(dtype):
    """(context, name) for SDPA as the yardstick: its default choice in
    bf16/f16 (the flash backend), the memory-efficient backend pinned in
    f32, which the flash backend refuses."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    if dtype == "float32":
        return (lambda: sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION),
                "EFFICIENT_ATTENTION (pinned)")
    return contextlib.nullcontext, "default"


def kernel_phase(cases=None):
    """Each kernel against its plain version on ``cases`` (names; all of
    CASES by default), the TIMED ones timed. f32 matrix products outside
    the kernels stay in full f32: ``allow_tf32`` must be False."""
    import torch
    import torch.nn.functional as F

    fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("torch.backends.cuda.matmul.allow_tf32 is set")
    log("torch.backends.cuda.matmul.allow_tf32 = False")

    failures, errors, readings, report = [], {}, {}, {}
    for (case, b, s_q, s_k, h, d, dtype, causal, window) in CASES:
        if cases is not None and case not in cases:
            continue
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
        backend, backend_name = _sdpa_backend(dtype)

        def sdpa():
            with torch.no_grad(), backend():
                return F.scaled_dot_product_attention(qt, kt_, vt,
                                                      is_causal=causal)
        # SDPA's forward runs once, on the stream the graphs are captured
        # on, so that its backward alone is captured and timed
        cap = torch.cuda.Stream()
        cap.wait_stream(torch.cuda.current_stream())
        qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt_, vt))
        gout = do.transpose(1, 2)
        with torch.cuda.stream(cap), backend():
            out = F.scaled_dot_product_attention(qg, kg, vg,
                                                 is_causal=causal)

        def sdpa_bwd():
            torch.autograd.grad(out, (qg, kg, vg), gout, retain_graph=True)
        # device time: each kernel and SDPA's forward and backward in
        # turns, 5 windows
        dev = _time_alternating({**kt, "sdpa_fwd": sdpa,
                                 "sdpa_bwd": sdpa_bwd}, stream=cap)

        def sdpa_fwd_bwd():
            with backend():
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
                "library_backend": backend_name,
                "tflops": _ops_per_pair(kname) * d * pairs
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


# The f32 cases of tests/test_flash_attention.py and its bf16 one, at its
# own bounds. name: (its _qkv draws in order from default_rng(0), each a
# (b, s, h, d) of three arrays: q is the first draw's first, k and v the
# last draw's second and third; dtype, causal, window, (rtol, atol) of o
# or None, (rtol, atol) of the gradients of (o ** 2).sum() or None).
_FWD_TOL, _GRAD_TOL = (2e-5, 2e-6), (5e-4, 5e-4)
_QKV, _SMALL, _LONG = (2, 64, 3, 32), (1, 32, 2, 16), (1, 600, 2, 32)
_CROSS = ((1, 100, 2, 16), (1, 260, 2, 16))
REFERENCE_CASES = {
    "matches_full": ((_QKV,), "float32", False, None, _FWD_TOL, None),
    "matches_full_causal": ((_QKV,), "float32", True, None, _FWD_TOL, None),
    "unaligned_seq": (((2, 50, 3, 32),), "float32", True, None, _FWD_TOL,
                      None),
    "bf16": ((_QKV,), "bfloat16", True, None, (0.05, 0.05), None),
    "gradients": ((_SMALL,), "float32", True, None, None, (2e-4, 2e-5)),
    "multiblock": ((_LONG,), "float32", False, None, None, _GRAD_TOL),
    "multiblock_causal": ((_LONG,), "float32", True, None, None, _GRAD_TOL),
    "cross_shapes": (_CROSS, "float32", False, None, None, _GRAD_TOL),
    "causal_rectangular": (_CROSS, "float32", True, None, None, _GRAD_TOL),
    "sliding_window": (((1, 300, 2, 16),), "float32", True, 64, (2e-4, 2e-5),
                       _GRAD_TOL),
}


def reference_inputs(case):
    """(q, k, v) of a reference case as float64 numpy arrays, before the
    reference rounds them to its dtype."""
    import numpy as np
    rng = np.random.default_rng(0)
    drawn = [[rng.standard_normal(shape) for _ in range(3)]
             for shape in REFERENCE_CASES[case][0]]
    return drawn[0][0], drawn[-1][1], drawn[-1][2]


def reference_phase():
    """Each kernel end to end at the JAX package's own tolerances, on
    REFERENCE_CASES: the forward without lse (no gradient), and the
    autograd Function, whose forward with lse hands its own lse and D to
    dQ and dK/dV for the gradient of (o ** 2).sum(). The truth is the
    plain versions in float64 on the same rounded inputs (the JAX test's
    truth is full attention in f32, which sits within its bounds of
    this). A case passes where every |err| / (atol + rtol |want|) is at
    most 1. Returns {kernel: {dtype: worst ratio}} and the ratios by
    case."""
    import torch

    fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")
    worst, cases, failures = {}, {}, []
    for case, (_, dtype, causal, window, fwd_tol,
               grad_tol) in REFERENCE_CASES.items():
        q, k, v = (torch.from_numpy(x).to("cuda", getattr(torch, dtype))
                   for x in reference_inputs(case))
        q64, k64, v64 = (t.double() for t in (q, k, v))
        scale = q.shape[-1] ** -0.5
        o64, lse64 = fa._fwd_reference(q64, k64, v64, causal, scale, window)
        checks = {}
        if fwd_tol is not None:
            with torch.no_grad():
                o = fa.flash_attention(q, k, v, causal, window=window)
            checks["fwd"] = [("o", o, o64, fwd_tol)]
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = fa.flash_attention(*leaves, causal=causal, window=window)
        if fwd_tol is not None:
            checks["fwd_lse"] = [("o", o.detach(), o64, fwd_tol)]
        if grad_tol is not None:
            (o ** 2).sum().backward()
            do64 = 2 * o64
            dvec = (do64 * o64).sum(-1).permute(0, 2, 1).contiguous()
            args = (q64, k64, v64, do64, lse64, dvec, causal, scale, window)
            dk64, dv64 = fa._bwd_dkv_reference(*args)
            checks["bwd_dq"] = [("dq", leaves[0].grad,
                                 fa._bwd_dq_reference(*args), grad_tol)]
            checks["bwd_dkv"] = [("dk", leaves[1].grad, dk64, grad_tol),
                                 ("dv", leaves[2].grad, dv64, grad_tol)]
        ratios = cases[case] = {}
        for kname, items in checks.items():
            for what, got, want, (rtol, atol) in items:
                got = got.double()
                ratio = ((got - want).abs() / (atol + rtol * want.abs())
                         ).max().item()
                if not (bool(torch.isfinite(got).all()) and ratio <= 1.0):
                    failures.append(f"{case}/{kname}/{what}: error / (atol "
                                    f"+ rtol |want|) {ratio:.3f} > 1")
                ratios[f"{kname}.{what}"] = ratio
                by_dtype = worst.setdefault(kname, {})
                by_dtype[dtype] = max(by_dtype.get(dtype, 0.0), ratio)
    log("kernels at the reference's tolerances (worst |err| / (atol + rtol "
        "|want|) a case):", json.dumps(cases))
    if failures:
        raise AssertionError("reference tolerances failed:\n"
                             + "\n".join(failures))
    return worst, cases


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


def _model(attn_impl="flash", device=None, **kw):
    import torch

    from byteps_tpu_torch.models import GPT2Small
    return GPT2Small(attn_impl=attn_impl, device=device,
                     generator=torch.Generator().manual_seed(0), **kw)


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
    from byteps_tpu_torch.training import make_train_step
    from byteps_tpu_torch.utils import timeline
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
        timeline.start_steps()  # PS mode: its legs are the trace's spans
        t0 = time.perf_counter()
        loss = step(model, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        staging.append(timeline.leg_seconds(timeline.stop_steps()))
    launches = dict(fa.LAUNCHES)
    _check_launches(label, launches, lm.layers, steps,
                    make_kw.get("remat", False))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: non-finite losses {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"{label}: losses {losses} step ms {[round(t, 1) for t in times]} "
        f"peak {peak_gb:.2f} GB")
    return model, step, batch, losses, times, staging, launches, peak_gb


# Host seconds between the marker events of ``_card_backlog``.
MARK_PERIOD_S = 5e-4
# Launches the card's queue holds before the next one blocks the host
# (H100, torch 2.11.0+cu128: 1021 of a small kernel, 1018 of the flash
# forward; tools/step_sync.py).
LAUNCH_QUEUE = 1021


def _sync_debug_step(run):
    """One ``run()`` under ``torch.cuda.set_sync_debug_mode("error")``,
    which raises at any synchronizing call PyTorch knows of. The caching
    allocator's counters are read before and after: a retry frees the
    cache with cudaFree, which waits for the card, and a new segment is a
    cudaMalloc; the debug mode sees neither. Returns their changes."""
    import torch
    keys = ("num_alloc_retries", "num_device_alloc", "num_device_free")
    before = torch.cuda.memory_stats()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    after = torch.cuda.memory_stats()
    return {k: after.get(k, 0) - before.get(k, 0) for k in keys}


def _card_backlog(run):
    """``run()`` enqueued behind a ~0.5 s sleep of the card (so that the
    host is ahead from the start): the card's ms for the step (CUDA events
    around it), the host's ms to enqueue it, the sleep's ms, and whether
    the card ever waited for the host in between.

    The card waits only where it has done all the work enqueued so far.
    A sampler thread records a marker event on the step's stream every
    MARK_PERIOD_S; between two markers a, b the card did not wait if the
    host had enqueued b (and so all the work before it) by the time the
    card reached a. ``backlog_ms`` is the least of (card reaches a) -
    (host has enqueued b) over consecutive markers, the sleep's end first
    and the step's end last: above 0, the card never waited and its time
    is exact (``device_ms_exact``). The card's times are put on the host's
    clock by an event recorded on the idle card right after a synchronize;
    its launch latency makes them early by microseconds, so the check errs
    towards "waited".

    The host may wait inside the enqueue without the card waiting: the
    launch queue holds LAUNCH_QUEUE launches, and a step of more blocks
    the host until the sleep ends (``host_waited``)."""
    import torch
    stream = torch.cuda.current_stream()
    marks, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(stream)
            marks.append((time.perf_counter(), ev))
            stop.wait(MARK_PERIOD_S)

    before, start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(3))
    torch.cuda.synchronize()
    h_before = time.perf_counter()
    before.record()
    torch.cuda._sleep(1_000_000_000)  # ~0.5 s at the H100's clocks
    start.record()
    marks.append((time.perf_counter(), start))
    sampler = threading.Thread(target=sample)
    sampler.start()
    t0 = time.perf_counter()
    try:
        run()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
    finally:
        stop.set()
        sampler.join()
    end.record()
    marks.append((time.perf_counter(), end))
    torch.cuda.synchronize()
    reached = [h_before + before.elapsed_time(ev) / 1e3 for _, ev in marks]
    backlog_ms = min(reached[i] - marks[i + 1][0]
                     for i in range(len(marks) - 1)) * 1e3
    sleep_ms = before.elapsed_time(start)
    return {"device_ms": start.elapsed_time(end),
            "enqueue_behind_sleep_ms": enqueue_ms, "sleep_ms": sleep_ms,
            "host_waited": enqueue_ms > sleep_ms, "markers": len(marks),
            "backlog_ms": backlog_ms, "device_ms_exact": backlog_ms > 0}


def _launch_counts(prof):
    """Launches a profiled step made, by the CUDA API calls the profiler
    saw on the host (each takes a slot of the launch queue), and the
    kernels it saw on the card."""
    import torch
    counts = {"kernel_launches": 0, "memset_memcpy": 0, "device_kernels": 0}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if "#" not in ev.name and "Mem" not in ev.name:
                counts["device_kernels"] += 1
        elif ev.name.startswith(("cudaLaunch", "cuLaunch")):
            counts["kernel_launches"] += 1
        elif ev.name.startswith(("cudaMemsetAsync", "cudaMemcpyAsync")):
            counts["memset_memcpy"] += 1
    return counts


def _profile_step(run, require_exact=False):
    """Four more training steps, ``run()``. The first is timed on the
    host: the time ``run()`` takes to return (the host enqueueing the
    step) against the time to the synchronize after it; the two are close
    when the host sets the step. The second runs under the sync debug
    mode (``_sync_debug_step``). The third measures the card's own time
    for the step behind a sleep (``_card_backlog``); 1 - that time / the
    unprofiled step is the idle share, exact where the card never waited
    for the host. The fourth runs under torch.profiler (CUDA activity):
    device time by kernel family, the union of the kernels' intervals and
    their span, the launches (``_launch_counts``). The profiler can lose
    kernels (ResNet-50's profile kept a fifth of the card's time), so
    ``profiled_share`` (union / the card's time) says how much of the step
    the families cover. A synchronizing call in the step fails it (the
    debug step raises); with ``require_exact`` an allocator retry or a
    card that waited for the host fails it too. The caller adds the idle
    share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    host = {"enqueue_ms": (t1 - t0) * 1e3,
            "step_ms": (time.perf_counter() - t0) * 1e3}
    allocator = _sync_debug_step(run)
    backlog = _card_backlog(run)
    device_ms = backlog.pop("device_ms")
    host.update(backlog)
    if require_exact and (allocator["num_alloc_retries"]
                          or not host["device_ms_exact"]):
        raise AssertionError(f"the card waited for the host in the step: "
                             f"{host}, allocator {allocator}")
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
             for k in ("fa_fwd_wgmma_kernel", "fa_fwd_tf32_kernel",
                       "fa_bwd_dq_wgmma_kernel", "fa_bwd_dkv_wgmma_kernel",
                       "fa_bwd_dq_tf32_kernel", "fa_bwd_dkv_tf32_kernel")}
    launches = _launch_counts(prof)
    # the step made no synchronizing call (the debug step above raises),
    # so a host that waited behind the sleep waited for a queue slot
    queued = launches["kernel_launches"] + launches["memset_memcpy"]
    host["host_wait"] = ("none" if not host["host_waited"] else
                         "launch queue full" if queued > LAUNCH_QUEUE else
                         "not explained")
    return {"host_timed_step": host, "device_ms": device_ms,
            "sync_debug_allocator": allocator, "launches": launches,
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


BF16_KERNELS = ("fa_fwd_wgmma_kernel", "fa_bwd_dq_wgmma_kernel",
                "fa_bwd_dkv_wgmma_kernel")
F32_KERNELS = ("fa_fwd_tf32_kernel", "fa_bwd_dq_tf32_kernel",
               "fa_bwd_dkv_tf32_kernel")


def _profile_lm(label, step, model, batch, times, kernels=BF16_KERNELS,
                require_exact=False):
    """``_profile_step`` of a collective LM step (the breakdown PERF.md
    reports: a profiler that fails, or sees no device time, fails the
    run); the forward, dQ and dK/dV must have run as ``kernels`` (with
    bf16 activations on the tensor cores)."""
    profile = _profile_step(lambda: step(model, batch), require_exact)
    for name in kernels:
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
        profile = _profile_lm("collective", step, model, tokens, times,
                              require_exact=True)
        del model
    finally:
        bps.shutdown()
    torch.cuda.empty_cache()
    return losses, times, launches, profile


def _free_port():
    """A TCP port for a rendezvous: ``utils.ports.free_port`` (outside the
    kernel's ephemeral range, never the same twice in a run)."""
    from byteps_tpu_torch.utils.ports import free_port
    return free_port()


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
    from byteps_tpu_torch.utils import timeline
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
            if label == "ps":  # its legs are the step trace's spans
                timeline.start_steps()
            t0 = time.perf_counter()
            loss = step(model, tokens)
            torch.cuda.synchronize()
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            for k, v in fa.LAUNCHES.items():
                out["launches"][k] += v
            out["losses"].append(loss.item())
            if label == "ps":
                out["staging"].append(
                    timeline.leg_seconds(timeline.stop_steps()))
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
    times, PS staging (the plain path's legs, ``timeline.leg_seconds``),
    the overlap's host clock readings, and the BatchNorm buffers after the
    last step. With ``keep`` the models and steps are returned too."""
    import torch

    from byteps_tpu_torch.utils import timeline
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
            if label in ("ps", "async"):
                timeline.start_steps()
            t0 = time.perf_counter()
            loss = run(batch)
            torch.cuda.synchronize()
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            out["launches"] += sum(fa.LAUNCHES.values())
            out["losses"].append(loss.item())
            if label in ("ps", "async"):
                out["staging"].append(
                    timeline.leg_seconds(timeline.stop_steps()))
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
        profile = _profile_step(lambda: run(batch), require_exact=True)
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


def _gpt2_medium(attn_impl="flash", **kw):
    import torch

    from byteps_tpu_torch.models import GPT2Medium
    return GPT2Medium(attn_impl=attn_impl,
                      generator=torch.Generator().manual_seed(0), **kw)


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
    from byteps_tpu_torch.utils.timeline import _CARD_PID, _DCN_PID, _HOST_PID
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if "ts" in e]
    core = [e for e in events if e.get("pid") == _DCN_PID
            and e.get("name") in ("push", "pull")]
    prof = [e for e in events
            if e.get("pid") not in (_DCN_PID, _HOST_PID, _CARD_PID)]
    lo = min(float(e["ts"]) for e in prof)
    hi = max(float(e["ts"]) + float(e.get("dur", 0)) for e in prof)
    kernels = {}
    for name in BF16_KERNELS:
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
# phase 9 (b)'s steps on the pair (see _sp_llama)
SP_STEPS = 2
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


@contextlib.contextmanager
def _flash_shapes():
    """The set of q shapes of every flash forward call made inside the
    block."""
    fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")
    shapes, real = set(), fa.flash_fwd

    def spy(q, *a, **kw):
        shapes.add(tuple(q.shape))
        return real(q, *a, **kw)
    fa.flash_fwd = spy
    try:
        yield shapes
    finally:
        fa.flash_fwd = real


def _sp_llama(sp, rank):
    """(b): Llama1B(flash) with the seed-0 weights and ``sp_group``, rank
    r holding tokens [r S/2, (r + 1) S/2) of (a)'s sequence (positions
    global by default): an evaluation forward at the seed-0 weights, then
    make_train_step steps of sp_lm_loss with (a)'s AdamW, the
    gradients averaged over the sp group. The flash wrapper's inputs are
    recorded (the inner call's shape). SP_STEPS steps, fewer than
    (a)'s: a step of the pair takes 15-27 s on gloo's loopback."""
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
    with _flash_shapes() as shapes:
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
        for _ in range(SP_STEPS):
            t0 = time.perf_counter()
            loss = step(model, tokens)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
        launches, moved = dict(fa.LAUNCHES), dict(C.BYTES)
    out = {"losses": losses, "step_ms": times, "launches": launches,
           "eval_launches": eval_launches,
           "flash_shapes": sorted(shapes),
           "bytes_per_step": {k: v / SP_STEPS for k, v in moved.items()},
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


def _run_pair(flag, tmp, timeout):
    """Start the two workers (``python chip_smoke.py FLAG TMP --rank R
    --port P``) in sessions of their own, wait for both, kill whatever is
    left; returns their records (TMP/rank<r>.json)."""
    import signal
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()
    procs = []
    for rank in range(SP_RANKS):
        out = open(os.path.join(tmp, f"worker{rank}.log"), "w")
        procs.append((out, subprocess.Popen(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"), flag,
             tmp, "--rank", str(rank), "--port", str(port)], env=env,
            cwd=HERE, stdout=out, stderr=subprocess.STDOUT,
            start_new_session=True)))
    deadline = time.monotonic() + timeout
    rcs = []
    for out, p in procs:
        try:
            rcs.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
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
        log(f"--- {flag} {rank} (exit {rcs[rank]}) ---\n"
            + text[-6000 if rcs[rank] != 0 else -600:])
    if rcs != [0] * SP_RANKS:
        raise AssertionError(f"{flag} workers exited {rcs}")
    recs = []
    for rank in range(SP_RANKS):
        with open(os.path.join(tmp, f"rank{rank}.json")) as f:
            recs.append(json.load(f))
    return recs


def _run_sp_workers():
    """Phase 9's two processes (``python chip_smoke.py --sp-worker``);
    returns their records."""
    import shutil
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sp_")
    try:
        return _run_pair("--sp-worker", tmp, SP_TIMEOUT_S)
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
        _check_launches(label, b["launches"], lm.layers, SP_STEPS)
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


# --- phase 10: tensor, pipeline and expert parallelism, ZeRO, the dry run -----

PAR_TIMEOUT_S = 600
# (a) TP and (b) PP: GPT-2 medium over 4 x PAR_SEQ tokens (the rows of
# (a)'s batch are (b)'s microbatches); (c) ZeRO: rows [4r, 4r + 4) of
# ZERO_ROWS x PAR_SEQ; each from default_rng(0)
PAR_ROWS, PAR_SEQ, ZERO_ROWS = 4, 1024, 8
PAR_LAYERS = GPT2M.layers
TP_PASSES, ZERO_STEPS = 2, 3
# (d): the MoE layer at Switch-Base-8's width (the Switch Transformer's
# base configuration: d_model 768, d_ff 3072, 8 experts), 4096 tokens a
# rank (8 x 512, GPT-2 small's batch); capacity factor by top-k
MOE = {"d": 768, "h": 3072, "experts": 8, "tokens": 4096}
MOE_CF = {1: 1.25, 2: 2.5}
# (a): relative distance allowed between a TP pass's loss and the dense
# run's: 20x the 5.0e-6 that the sound pair read on an H100 (bf16 partial
# products summed after rounding), a planted fault's reading beside it in
# tools/par_gate_controls.py
TP_LOSS_REL = 1e-4
# (b): relative L2 distance allowed between a schedule's gradients and the
# microbatch-wise run's. The forward is the same arithmetic on the same
# inputs; the gradients differ only in the order of the f32 sums over
# microbatches (GPipe's backward runs them last to first).
PP_GRAD_REL_L2 = 1e-4
# (d): EP against the dense layer, both in f32: the output within 1e-5
# relative (relative L2, and the largest error against the output's
# largest element), the weights' gradients within 1e-4 relative L2 (f32
# sums of up to 2 x 4096 products in another order)
MOE_OUT_REL, MOE_GRAD_REL_L2 = 1e-5, 1e-4


def _par_tokens(device, rows=PAR_ROWS):
    return _tokens(device, rows, PAR_SEQ)


def _rel_l2(got, want):
    """||got - want|| / ||want|| over two equal lists of tensors, in
    float64."""
    num = sum(float((a.double() - b.double()).norm() ** 2)
              for a, b in zip(got, want))
    den = sum(float(b.double().norm() ** 2) for b in want)
    return math.sqrt(num / den)


def _tp_shards(model, group):
    """This rank's shards, as leaf tensors, of each layer's query, key
    and value kernels (columns: its heads), out kernel (rows) and MLP
    (mlp_in's kernel and bias by columns, mlp_out's kernel by rows)."""
    from byteps_tpu_torch.parallel import shard_columns, shard_rows
    shards = []
    for layer in model.layers:
        a = layer.attention
        d = a.query.kernel.shape[0]
        sh = {k: shard_columns(getattr(a, k).kernel.reshape(d, -1), group)
              for k in ("query", "key", "value")}
        sh["out"] = shard_rows(a.out.kernel.reshape(-1, d), group)
        sh["mlp_in"] = shard_columns(layer.mlp_in.kernel, group)
        sh["mlp_in_bias"] = shard_columns(layer.mlp_in.bias, group)
        sh["mlp_out"] = shard_rows(layer.mlp_out.kernel, group)
        shards.append({k: v.detach().clone().requires_grad_()
                       for k, v in sh.items()})
    return shards


def _tp_forward(model, shards, tokens, group):
    """GPT-2 with each layer's attention as ``tp_attention`` around the
    flash kernels and its MLP as ``tp_mlp`` over ``group``, in the model's
    dtype; the embedding, the layer norms, mlp_out's bias and the tied
    head are the model's own (replicated). The attention biases are zero
    at seed-0 init, so this is the dense model's function."""
    import torch

    from byteps_tpu_torch.ops.flash_attention import flash_attention
    from byteps_tpu_torch.parallel import tp_attention, tp_mlp
    from byteps_tpu_torch.parallel._collectives import group_size

    dt = model.dtype
    pos = torch.arange(tokens.shape[1], device=tokens.device)[None]
    x = model.tok_embed(tokens) + model.pos_embed(pos)
    heads = model.layers[0].attention.query.kernel.shape[1]
    for layer, sh in zip(model.layers, shards):
        y = tp_attention(
            layer.ln_0(x).to(dt),
            *(sh[k].to(dt) for k in ("query", "key", "value", "out")),
            group=group, num_local_heads=heads // group_size(group),
            causal=True, attn_fn=flash_attention)
        x = x + y.to(x.dtype)
        y = tp_mlp(layer.ln_1(x).to(dt), sh["mlp_in"].to(dt),
                   sh["mlp_out"].to(dt), group=group,
                   b_in_shard=sh["mlp_in_bias"].to(dt),
                   b_out=layer.mlp_out.bias.to(dt))
        x = x + y.to(x.dtype)
    return model.tok_embed.attend(model.final_ln(x)).float()


def _par_tp(group, rank, tmp):
    """(a): TP_PASSES forward and backward passes of the TP GPT-2 medium
    (the loss, whole on each rank, divided by the pair's size for the
    backward), then an evaluation forward. Writes the last pass's shard
    gradients and replicated parameters' gradients to TMP/tp<rank>.pt."""
    import torch

    from byteps_tpu_torch.models import lm_loss
    from byteps_tpu_torch.parallel import _collectives as C
    from byteps_tpu_torch.parallel._collectives import group_size
    fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")

    n = group_size(group)
    tokens = _par_tokens("cuda")
    model = _gpt2_medium()
    shards = _tp_shards(model, group)
    losses, times, grads = [], [], None
    with _flash_shapes() as shapes:
        torch.cuda.synchronize()
        fa.reset_launches()
        C.reset_bytes()
        for _ in range(TP_PASSES):
            model.zero_grad(set_to_none=True)
            for sh in shards:
                for t in sh.values():
                    t.grad = None
            t0 = time.perf_counter()
            loss = lm_loss(_tp_forward(model, shards, tokens, group), tokens)
            (loss / n).backward()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
            prev, grads = grads, [t.grad for sh in shards for t in sh.values()]
        launches, moved = dict(fa.LAUNCHES), dict(C.BYTES)
        same = all(torch.equal(a, b) for a, b in zip(prev, grads))
        fa.reset_launches()
        with torch.no_grad():
            eval_loss = lm_loss(_tp_forward(model, shards, tokens, group),
                                tokens).item()
        torch.cuda.synchronize()
        eval_launches = dict(fa.LAUNCHES)
    torch.save({"shards": [{k: t.grad.cpu() for k, t in sh.items()}
                           for sh in shards],
                "replicated": {k: p.grad.cpu()
                               for k, p in model.named_parameters()
                               if p.grad is not None}},
               os.path.join(tmp, f"tp{rank}.pt"))
    out = {"losses": losses, "ms": times, "eval_loss": eval_loss,
           "heads": list(model.layers[0].attention.query.kernel.shape[1:]),
           "passes_equal": same, "launches": launches,
           "eval_launches": eval_launches, "flash_shapes": sorted(shapes),
           "bytes_per_pass": {k: v / TP_PASSES for k, v in moved.items()},
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del model, shards, grads, prev
    _free()
    return out


def _pp_parts(model, tokens):
    """(microbatches, stage function, loss function) of (b): the
    embedding of each row of ``tokens`` (outside the pipeline), the
    layers run in order, the final LN + tied head + lm_loss."""
    import torch

    from byteps_tpu_torch.models import lm_loss
    mb_tokens = tokens[:, None]  # [M, 1, seq]
    pos = torch.arange(tokens.shape[1], device=tokens.device)[None]
    with torch.no_grad():
        mbs = torch.stack([model.tok_embed(t) + model.pos_embed(pos)
                           for t in mb_tokens])

    def stage(layers, x):
        for layer in layers:
            x = layer(x)
        return x

    def head_loss(y, t):
        return lm_loss(model.tok_embed.attend(model.final_ln(y)).float(), t)

    return mbs, mb_tokens, stage, head_loss


def _par_pp(group, rank, tmp):
    """(b): layers [12 r, 12 r + 12) of GPT-2 medium on rank r, M = 4
    microbatches of [1, PAR_SEQ] tokens, through pipeline_1f1b and
    gpipe differentiated by autograd (the loss divided by the pair's
    size), twice in turns. Writes both schedules' layer gradients to
    TMP/pp<rank>.pt."""
    import torch

    from byteps_tpu_torch.parallel import gpipe, pipeline_1f1b
    from byteps_tpu_torch.parallel._collectives import group_size
    fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")

    n = group_size(group)
    model = _gpt2_medium()
    per = len(model.layers) // n
    layers = model.layers[rank * per:(rank + 1) * per]
    mbs, mb_tokens, stage, head_loss = _pp_parts(model, _par_tokens("cuda"))
    out, saved, ms = {}, {}, {"1f1b": [], "gpipe": []}
    with _flash_shapes() as shapes:
        # twice in turns: the first round pays one-time costs, the
        # second's launches, peaks and gradients are read
        for name in ("1f1b", "gpipe") * 2:
            model.zero_grad(set_to_none=True)
            _free()
            fa.reset_launches()
            t0 = time.perf_counter()
            if name == "1f1b":
                loss, grads = pipeline_1f1b(stage, head_loss, layers, mbs,
                                            mb_tokens, group=group)
            else:
                y = gpipe(stage, layers, mbs, group=group)
                loss = torch.stack([head_loss(y[i], mb_tokens[i])
                                    for i in range(len(mbs))]).mean()
                (loss / n).backward()
                grads = [p.grad for p in layers.parameters()]
                del y
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
            out[name] = {"loss": loss.item(), "ms": ms[name],
                         "launches": dict(fa.LAUNCHES),
                         "peak_memory_gb":
                             torch.cuda.max_memory_allocated() / 1e9}
            saved[name] = [g.cpu() for g in grads]
            del loss, grads
    out["flash_shapes"] = sorted(shapes)
    out["rel_l2_1f1b_gpipe"] = _rel_l2(saved["1f1b"], saved["gpipe"])
    torch.save(saved, os.path.join(tmp, f"pp{rank}.pt"))
    del model, layers, mbs, saved
    _free()
    return out


def _par_zero(group, rank):
    """(c): GPT-2 medium on rows [4r, 4r + 4) of ZERO_ROWS x PAR_SEQ,
    ZERO_STEPS steps of make_train_step with AdamW over the pair, then
    the same from the same weights with make_zero_train_step; the two
    runs' losses and parameters compared here."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.parallel import (make_zero_train_step,
                                           zero_init_sharded)
    from byteps_tpu_torch.parallel import _collectives as C
    from byteps_tpu_torch.parallel._collectives import group_size
    from byteps_tpu_torch.training import make_train_step
    fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")

    half = ZERO_ROWS // group_size(group)
    tokens = _par_tokens("cuda", ZERO_ROWS)[rank * half:(rank + 1) * half]

    def adamw(params):
        return torch.optim.AdamW(params, lr=1e-4, weight_decay=1e-4)
    bps.init(group=group)
    out, dense = {}, None
    try:
        for name in ("dense", "zero"):
            _free()
            model = _gpt2_medium()
            if name == "dense":
                opt = adamw(model.parameters())
                step = make_train_step(_loss_fn, opt)
            else:
                opt = zero_init_sharded(model, adamw)
                step = make_zero_train_step(_loss_fn, opt)
            losses, times = [], []
            torch.cuda.synchronize()
            fa.reset_launches()
            C.reset_bytes()
            for _ in range(ZERO_STEPS):
                t0 = time.perf_counter()
                loss = step(model, tokens)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                losses.append(loss.item())
            out[name] = {
                "losses": losses, "step_ms": times,
                "launches": dict(fa.LAUNCHES),
                "staged_bytes_per_step": C.BYTES["staged"] / ZERO_STEPS,
                "adamw_state_elements": sum(
                    st[k].numel() for st in opt.state.values()
                    for k in ("exp_avg", "exp_avg_sq")),
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
            params = [p.detach() for p in model.parameters()]
            if dense is None:
                # on the host, out of the ZeRO run's peak
                dense = [p.cpu() for p in params]
                out["n_params"] = sum(p.numel() for p in params)
            else:
                diff = [((z - d.to(z.device)).abs(), d.to(z.device).abs())
                        for z, d in zip(params, dense)]
                out["param_err_over_tolerance"] = max(
                    (e / (1e-6 + 1e-5 * a)).max().item() for e, a in diff)
                out["param_max_abs_diff"] = max(e.max().item()
                                                for e, _ in diff)
                out["params_equal"] = all(e.max().item() == 0
                                          for e, _ in diff)
                del diff
            del model, opt, step, params
    finally:
        bps.shutdown()
    del dense
    _free()
    return out


def _moe_inputs(device):
    """(x [2 x tokens, d] and the loss's probe of the same shape from
    default_rng(0), gate_w, w1, w2 drawn with std 1/sqrt(fan in) from a
    seed-0 generator), all f32. The tokens share a mean (a quarter of
    one more standard normal row), as the hidden states of one batch do;
    it skews the router, so that some experts overflow their capacity
    (about 7 % of the tokens at top-1; isotropic tokens load every expert
    within a few % of T/E and drop none)."""
    import numpy as np
    import torch
    d, h, e, t = MOE["d"], MOE["h"], MOE["experts"], MOE["tokens"]
    rng = np.random.default_rng(0)
    x, probe = (rng.standard_normal((SP_RANKS * t, d)).astype(np.float32)
                for _ in range(2))
    x += 0.25 * rng.standard_normal(d).astype(np.float32)
    x, probe = (torch.from_numpy(a).to(device) for a in (x, probe))
    g = torch.Generator().manual_seed(0)
    w = [torch.randn(s, generator=g).div_(math.sqrt(s[-2])).to(device)
         for s in ((d, e), (e, d, h), (e, h, d))]
    return x, probe, w


def _moe_run(x, probe, weights, top_k, group=None):
    """One forward and backward of moe_ffn (loss sum(y * probe) + aux):
    (y, aux, the weights' gradients, the tokens (top-1) or choices
    (top-2) dropped by the capacity). Over a group the count is the EP
    path's own: of the [E, C, d] expert outputs that its second
    all-to-all brings home, an empty slot is a zero row (gelu(0) = 0) and
    a kept one is not. The dense layer's is moe_dispatch's."""
    import torch

    from byteps_tpu_torch.parallel import moe
    ws = [w.detach().clone().requires_grad_() for w in weights]
    cf = MOE_CF[top_k]
    a2a, homes = moe.all_to_all, []

    def kept_a2a(*args, **kw):
        out = a2a(*args, **kw)
        homes.append(out.detach())
        return out
    moe.all_to_all = kept_a2a
    try:
        y, aux = moe.moe_ffn(x, *ws, capacity_factor=cf, group=group,
                             top_k=top_k)
    finally:
        moe.all_to_all = a2a
    ((y * probe).sum() + aux).backward()
    t = x.shape[0]
    with torch.no_grad():
        if group is None:
            dispatch_fn = (moe.moe_dispatch if top_k == 1
                           else moe.moe_dispatch_top2)
            kept = dispatch_fn(x @ weights[0],
                               max(1, int(cf * t / MOE["experts"])))[0].sum()
        else:
            kept = (homes[-1] != 0).any(-1).sum()
    return y.detach(), aux.item(), [w.grad for w in ws], top_k * t - int(kept)


def _par_moe(group, rank, tmp):
    """(d): the MoE layer over the pair (``group``: ep = 2), this rank's
    MOE["tokens"] tokens, top-1 and top-2, forward and backward. Writes
    the outputs and gradients to TMP/moe<rank>.pt."""
    import torch

    from byteps_tpu_torch.parallel import _collectives as C
    x, probe, weights = _moe_inputs("cuda")
    t = MOE["tokens"]
    rows = slice(rank * t, (rank + 1) * t)
    out, saved = {}, {}
    for k in (1, 2):
        C.reset_bytes()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, aux, grads, dropped = _moe_run(x[rows], probe[rows], weights, k,
                                          group)
        torch.cuda.synchronize()
        out[f"top{k}"] = {"ms": (time.perf_counter() - t0) * 1e3,
                          "aux": aux, "dropped": dropped,
                          "all_to_all_bytes": C.BYTES["all_to_all"],
                          "staged_bytes": C.BYTES["staged"]}
        saved[k] = {"y": y.cpu(), "grads": [g.cpu() for g in grads]}
    torch.save(saved, os.path.join(tmp, f"moe{rank}.pt"))
    del x, probe, weights, saved
    _free()
    return out


def par_worker(out_dir, rank, port):
    """One of phase 10's two processes (``python chip_smoke.py
    --par-worker DIR --rank R --port P``), on cuda:0 in a gloo group as
    phase 9's: (a) TP, (b) PP, (c) ZeRO, (d) EP and (e) the dry run;
    writes DIR/rank<r>.json and the gradients that phase 10's gates read
    (DIR/tp<r>.pt, pp<r>.pt, moe<r>.pt)."""
    import datetime

    import torch
    import torch.distributed as dist

    from byteps_tpu_torch.dryrun import dryrun_multichip
    from byteps_tpu_torch.parallel import Mesh

    torch.cuda.set_device(0)
    os.environ["BYTEPS_PS_MODE"] = "collective"
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=SP_RANKS,
        timeout=datetime.timedelta(seconds=PAR_TIMEOUT_S))
    try:
        pair = Mesh((SP_RANKS,), ("pair",)).group("pair")
        t0 = time.perf_counter()
        rec = {}
        for key, run in (("a", lambda: _par_tp(pair, rank, out_dir)),
                         ("b", lambda: _par_pp(pair, rank, out_dir)),
                         ("c", lambda: _par_zero(pair, rank)),
                         ("d", lambda: _par_moe(pair, rank, out_dir)),
                         ("e", lambda: dryrun_multichip(SP_RANKS,
                                                        device="cuda"))):
            rec[key] = run()
            log(f"par worker {rank}: ({key}) done at "
                f"{time.perf_counter() - t0:.1f} s")
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    return 0


def _par_references():
    """The one-process runs phase 10's gates hold the pair to, on the
    card, kept on the host: (a) the dense GPT-2 medium's loss and
    gradients on (a)'s tokens; (b) the same 24 layers microbatch by
    microbatch, each microbatch's loss / M backward, the gradients
    accumulated in f32; (d) the dense MoE layer on each rank's tokens."""
    import torch

    from byteps_tpu_torch.models import lm_loss
    ref = {}
    model = _gpt2_medium()
    tokens = _par_tokens("cuda")
    loss = lm_loss(model(tokens), tokens)
    loss.backward()
    ref["tp_loss"] = loss.item()
    ref["tp_grads"] = {k: p.grad.cpu() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    mbs, mb_tokens, stage, head_loss = _pp_parts(model, tokens)
    losses = []
    for i in range(len(mbs)):
        loss = head_loss(stage(model.layers, mbs[i]), mb_tokens[i]) / len(mbs)
        loss.backward()
        losses.append(loss.item())
    ref["pp_loss"] = sum(losses)
    ref["pp_grads"] = [p.grad.cpu() for p in model.layers.parameters()]
    del model, loss, mbs
    _free()
    x, probe, weights = _moe_inputs("cuda")
    t = MOE["tokens"]
    for k in (1, 2):
        runs = [_moe_run(x[r * t:(r + 1) * t], probe[r * t:(r + 1) * t],
                         weights, k) for r in range(SP_RANKS)]
        ref[f"moe{k}"] = {
            "y": [r[0].cpu() for r in runs],
            "dropped": [r[3] for r in runs],
            "grads": [sum(r[2][i] for r in runs).cpu() for i in range(3)]}
        del runs
    del x, probe, weights
    _free()
    return ref


# (a)'s shards: the dense parameter each slices, and the dim of the
# [d, heads x head_dim] (or [heads x head_dim, d]) matrix it slices
TP_SHARDED = {"query": ("attention.query.kernel", 1),
              "key": ("attention.key.kernel", 1),
              "value": ("attention.value.kernel", 1),
              "out": ("attention.out.kernel", 0),
              "mlp_in": ("mlp_in.kernel", 1),
              "mlp_in_bias": ("mlp_in.bias", 0),
              "mlp_out": ("mlp_out.kernel", 0)}


def _tp_gathered(ref, tmp):
    """(a)'s gathered gradients beside the dense ones: the six kernels'
    and mlp_in's bias shards concatenated in rank order, the replicated
    parameters' summed over the pair. Returns (got, want) lists."""
    import torch
    runs = [torch.load(os.path.join(tmp, f"tp{r}.pt"))
            for r in range(SP_RANKS)]
    want, got, names = ref["tp_grads"], [], []
    for i in range(len(runs[0]["shards"])):
        for k, (name, dim) in TP_SHARDED.items():
            whole = torch.cat([r["shards"][i][k] for r in runs], dim=dim)
            names.append(f"layers.{i}.{name}")
            got.append(whole.reshape(want[names[-1]].shape))
    for name in runs[0]["replicated"]:
        got.append(sum(r["replicated"][name] for r in runs))
        names.append(name)
    return got, [want[n] for n in names]


def par_phase():
    """Phase 10. The one-process references in this process
    (``_par_references``), freed from the card, then two processes on
    the card in a gloo group (``par_worker``; the port stages their
    collectives through host memory): (a) GPT-2 medium with TP = 2, (b)
    its 24 layers as two pipeline stages, 1F1B and GPipe, (c) ZeRO
    against make_train_step, (d) the Switch-Base-8 MoE layer with EP =
    2, (e) the dry run. Gates, each written before the run that first
    read it:
    - (a) on each rank: every pass's loss within TP_LOSS_REL of the
      dense loss (relative), the gathered shard gradients and the
      replicated parameters' gradients summed over the pair within
      RING_GRAD_REL_L2 of the dense gradients (relative L2); #1, #3 and
      #4 launched 24
      times a pass, #2 never in training and 24 times (alone) in the
      evaluation forward; every flash call at [4, PAR_SEQ, 8, 64];
    - (b) on each rank: both schedules' mean loss equal to the
      microbatch-wise run's to rtol 1e-5; each schedule's gradients of
      the 24 layers (the two ranks' 12 each) within PP_GRAD_REL_L2 of
      it, and 1F1B's within PP_GRAD_REL_L2 of GPipe's; 1F1B launches
      #2, #1, #3 and #4 12 x M times each, GPipe #1, #3 and #4 12 x
      (M + 1) times each (the stage runs on every tick) and #2 never;
      every flash call at [1, PAR_SEQ, 16, 64];
    - (c) on each rank: ZeRO's losses and parameters equal to
      make_train_step's to rtol 1e-5, atol 1e-6 (the JAX test's); its
      AdamW state 2 x ceil(n / 2) elements against 2 n; 24 launches of
      #1, #3, #4 a step on both paths;
    - (d): each rank's EP output within MOE_OUT_REL of the dense layer's
      on its tokens, the same tokens dropped (counted from the EP
      path's own all-to-all, ``_moe_run``), the weights' gradients
      summed over the pair within MOE_GRAD_REL_L2 of the two dense runs'
      sum, top-1 and top-2;
    - (e): dryrun_multichip(2) completes, finite, on both ranks."""
    import shutil

    import torch

    ref = _par_references()
    held_gb = {"allocated": torch.cuda.memory_allocated() / 1e9,
               "reserved": torch.cuda.memory_reserved() / 1e9}
    log("before phase 10's processes this one holds (GB):",
        json.dumps(held_gb))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_par_")
    try:
        recs = _run_pair("--par-worker", tmp, PAR_TIMEOUT_S)
        gates = _par_gates(ref, recs, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"references": {"tp_loss": ref["tp_loss"], "pp_loss":
                          ref["pp_loss"],
                          "moe_dropped": {k: ref[f"moe{k}"]["dropped"]
                                          for k in (1, 2)}},
           "main_process_held_gb": held_gb, "gates": gates, "ranks": recs}
    log("phase 10 (TP, PP, ZeRO, EP, dry run):", json.dumps(out))
    return out


def _par_gates(ref, recs, tmp):
    """Phase 10's gates (``par_phase``); returns what they read."""
    import torch

    m, layers = PAR_ROWS, PAR_LAYERS
    per = layers // SP_RANKS
    got, want = _tp_gathered(ref, tmp)
    out = {"tp_grad_rel_l2": _rel_l2(got, want)}
    del got, want
    pp = [torch.load(os.path.join(tmp, f"pp{r}.pt")) for r in range(SP_RANKS)]
    for name in ("1f1b", "gpipe"):
        out[f"pp_{name}_grad_rel_l2"] = _rel_l2(
            [g for r in pp for g in r[name]], ref["pp_grads"])
    del pp
    moe = [torch.load(os.path.join(tmp, f"moe{r}.pt"))
           for r in range(SP_RANKS)]
    for k in (1, 2):
        dense = ref[f"moe{k}"]
        out[f"moe{k}"] = {
            "out_rel_l2": [_rel_l2([moe[r][k]["y"]], [dense["y"][r]])
                           for r in range(SP_RANKS)],
            "out_max_err_over_max": [
                ((moe[r][k]["y"] - dense["y"][r]).abs().max()
                 / dense["y"][r].abs().max()).item()
                for r in range(SP_RANKS)],
            "grad_rel_l2": _rel_l2(
                [sum(moe[r][k]["grads"][i] for r in range(SP_RANKS))
                 for i in range(3)], dense["grads"])}
    del moe
    log("phase 10 gates read:", json.dumps(out))

    fails = []
    if not out["tp_grad_rel_l2"] <= RING_GRAD_REL_L2:
        fails.append(f"(a) gradients {out['tp_grad_rel_l2']}")
    for name in ("1f1b", "gpipe"):
        if not out[f"pp_{name}_grad_rel_l2"] <= PP_GRAD_REL_L2:
            fails.append(f"(b) {name} gradients "
                         f"{out[f'pp_{name}_grad_rel_l2']}")
    for k in (1, 2):
        o = out[f"moe{k}"]
        if not (max(o["out_rel_l2"]) <= MOE_OUT_REL
                and max(o["out_max_err_over_max"]) <= MOE_OUT_REL
                and o["grad_rel_l2"] <= MOE_GRAD_REL_L2):
            fails.append(f"(d) top-{k}: {o}")
    for rank, rec in enumerate(recs):
        a, b, c, d, e = (rec[k] for k in "abcde")
        for loss in a["losses"] + [a["eval_loss"]]:
            if not abs(loss - ref["tp_loss"]) <= TP_LOSS_REL * abs(
                    ref["tp_loss"]):
                fails.append(f"(a) rank {rank} loss {loss} vs dense "
                             f"{ref['tp_loss']}")
        want = {"fwd_lse": layers * TP_PASSES, "fwd": 0,
                "bwd_dq": layers * TP_PASSES, "bwd_dkv": layers * TP_PASSES}
        if a["launches"] != want or a["eval_launches"] != {
                "fwd_lse": 0, "fwd": layers, "bwd_dq": 0, "bwd_dkv": 0}:
            fails.append(f"(a) rank {rank} launches {a['launches']}, "
                         f"evaluation {a['eval_launches']}")
        heads, head_dim = a["heads"]
        if a["flash_shapes"] != [[PAR_ROWS, PAR_SEQ, heads // SP_RANKS,
                                  head_dim]]:
            fails.append(f"(a) rank {rank} flash shapes {a['flash_shapes']}")
        for name, want in (
                ("1f1b", {k: per * m for k in ("fwd_lse", "fwd", "bwd_dq",
                                               "bwd_dkv")}),
                ("gpipe", {"fwd_lse": per * (m + SP_RANKS - 1), "fwd": 0,
                           "bwd_dq": per * (m + SP_RANKS - 1),
                           "bwd_dkv": per * (m + SP_RANKS - 1)})):
            if b[name]["launches"] != want:
                fails.append(f"(b) rank {rank} {name} launches "
                             f"{b[name]['launches']}, expected {want}")
            if not abs(b[name]["loss"] - ref["pp_loss"]) <= 1e-5 * abs(
                    ref["pp_loss"]):
                fails.append(f"(b) rank {rank} {name} loss "
                             f"{b[name]['loss']} vs {ref['pp_loss']}")
        if not b["rel_l2_1f1b_gpipe"] <= PP_GRAD_REL_L2:
            fails.append(f"(b) rank {rank} 1F1B vs GPipe "
                         f"{b['rel_l2_1f1b_gpipe']}")
        if b["flash_shapes"] != [[1, PAR_SEQ, heads, head_dim]]:
            fails.append(f"(b) rank {rank} flash shapes {b['flash_shapes']}")
        zl, dl = c["zero"]["losses"], c["dense"]["losses"]
        if not (all(abs(z - d_) <= 1e-6 + 1e-5 * abs(d_)
                    for z, d_ in zip(zl, dl))
                and c["param_err_over_tolerance"] <= 1.0):
            fails.append(f"(c) rank {rank}: losses {zl} vs {dl}, "
                         f"parameters {c['param_err_over_tolerance']} of "
                         f"the tolerance")
        n = c["n_params"]
        if (c["zero"]["adamw_state_elements"] != 2 * -(-n // SP_RANKS)
                or c["dense"]["adamw_state_elements"] != 2 * n):
            fails.append(f"(c) rank {rank} AdamW state "
                         f"{c['zero']['adamw_state_elements']} / "
                         f"{c['dense']['adamw_state_elements']} of {n}")
        for name in ("dense", "zero"):
            _check_launches(f"(c) rank {rank} {name}", c[name]["launches"],
                            layers, ZERO_STEPS)
        for k in (1, 2):
            if d[f"top{k}"]["dropped"] != ref[f"moe{k}"]["dropped"][rank]:
                fails.append(f"(d) rank {rank} top-{k} dropped "
                             f"{d[f'top{k}']['dropped']} vs dense "
                             f"{ref[f'moe{k}']['dropped'][rank]}")
        if not all(math.isfinite(v) for v in e.values()):
            fails.append(f"(e) rank {rank}: {e}")
    if fails:
        raise AssertionError("phase 10 failed:\n" + "\n".join(fails))
    return out


# --- phase 11: two hosts of two ranks in PS mode on one card -----------------

LOCAL_HOSTS, LOCAL_SIZE, LOCAL_STEPS, LOCAL_TIMEOUT_S = 2, 2, 2, 600
# the PS paths of a host of LOCAL_SIZE ranks, with the wire each sums
LOCAL_PATHS = {"ps": "float32", "overlap_f32": "float32",
               "overlap_bf16": "bfloat16", "bucketed_multi": "float32",
               "distributed_optimizer": "float32"}


def _local_rows(rank):
    return slice(2 * rank, 2 * rank + 2)


def _local_reference(tmp):
    """The one-process run phase 11 holds the fleet to, on the card:
    GPT2Small(flash) with the seed-0 weights and phase 3's AdamW; each
    step computes the four ranks' gradients on their rows of phase 3's
    tokens, combines them in the fleet's order (within a host the
    two-operand sum over 2, the local mean; then the servers' two-operand
    sum over the hosts, their mean) and steps. Writes the parameters
    after LOCAL_STEPS steps to TMP/reference.pt; returns (each rank's
    losses, each parameter's number of elements)."""
    import torch

    model = GPT2.make()
    params = list(model.parameters())
    opt = torch.optim.AdamW(params, lr=1e-4, weight_decay=1e-4)
    tokens = GPT2.batch(torch.device("cuda"))
    ranks = LOCAL_HOSTS * LOCAL_SIZE
    losses = [[] for _ in range(ranks)]
    for _ in range(LOCAL_STEPS):
        grads = []
        for r in range(ranks):
            opt.zero_grad(set_to_none=True)
            loss = GPT2.loss(model, tokens[_local_rows(r)])
            loss.backward()
            losses[r].append(loss.item())
            grads.append([p.grad for p in params])
        for i, p in enumerate(params):
            hosts = [(grads[2 * h][i] + grads[2 * h + 1][i]) / LOCAL_SIZE
                     for h in range(LOCAL_HOSTS)]
            p.grad = (hosts[0] + hosts[1]) / LOCAL_HOSTS
        opt.step()
        del grads
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               os.path.join(tmp, "reference.pt"))
    numels = [p.numel() for p in params]
    del model, params, opt
    torch.cuda.empty_cache()
    return losses, numels


def _local_step_record(label, step, legs):
    """One step's staging readings on this rank: the five legs' seconds,
    the bytes copied into the host's shared staging and pushed, and the
    exposed communication (the hook-driven paths). ``legs``: the plain
    path's, from the step trace (``timeline.leg_seconds``)."""
    if label == "ps":
        return {"split_s": {k: legs[k + "_s"] for k in (
                    "reduce_scatter", "d2h", "core", "h2d", "all_gather")},
                "d2h_bytes": legs["d2h_bytes"],
                "pushed_bytes": legs["pushed_bytes"]}
    t = step.timings
    return {"split_s": dict(t["split_s"]),
            "d2h_bytes": sum(n for _, n in t["staged"]),
            "pushed_bytes": sum(n for _, n in t["pushes"]),
            "exposed_ms": (t["landed"] - t["backward"]) * 1e3,
            "staged_before_backward_share": sum(
                n for ts, n in t["staged"] if ts < t["backward"]) / max(
                1, sum(n for _, n in t["staged"]))}


def local_ps_worker(out_dir, port):
    """One process of phase 11 (``python chip_smoke.py --local-ps-worker
    DIR --port P``), started by the port's launcher with
    ``--workers-per-host 2`` (BYTEPS_LOCAL_RANK, BYTEPS_LOCAL_SIZE) for
    host DMLC_WORKER_ID: on cuda:0 (every process shares the one card) in
    a gloo group with its host's other rank (rendezvous at localhost:P),
    PS mode, LOCAL_STEPS steps of each path of LOCAL_PATHS from the
    seed-0 weights on rows [2 r, 2 r + 2) of phase 3's tokens for global
    rank r, then an evaluation forward. Writes DIR/host<h>_rank<l>.json;
    compares its parameters after each path with DIR/reference.pt."""
    import datetime
    import gc

    import torch
    import torch.distributed as dist

    import byteps_tpu_torch as bps
    from byteps_tpu_torch import local_stage
    from byteps_tpu_torch.parallel import _collectives as C
    from byteps_tpu_torch.utils import timeline
    fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")

    torch.cuda.set_device(0)
    # the directories this process's segments were made in (local rank 0
    # makes them), which the main process lists for files left behind
    made_in, choose = set(), local_stage.stage_dir

    def stage_dir(nbytes):
        where = choose(nbytes)
        made_in.add(where)
        return where
    local_stage.stage_dir = stage_dir
    local = int(os.environ["BYTEPS_LOCAL_RANK"])
    host = int(os.environ["DMLC_WORKER_ID"])
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=local,
        world_size=int(os.environ["BYTEPS_LOCAL_SIZE"]),
        timeout=datetime.timedelta(seconds=LOCAL_TIMEOUT_S))
    t_start = time.perf_counter()
    bps.init(device="cuda:0")
    try:
        rank, size = bps.rank(), bps.size()
        rec = {"host": host, "local_rank": local, "rank": rank,
               "size": size, "client": bps._st().ps_client is not None,
               "hosts": bps._hosts()[1], "paths": {}}
        ref = torch.load(os.path.join(out_dir, "reference.pt"))
        tokens = GPT2.batch(bps.device())[_local_rows(rank)]
        # the default device of local rank 1 is cuda:1; every process
        # here shares the one card
        lm = GPT2._replace(make=lambda *a, **k: GPT2.make(
            *a, device=bps.device(), **k))
        for label in LOCAL_PATHS:
            torch.cuda.reset_peak_memory_stats()
            model, step = _ps_path(label, lm)
            out = {"losses": [], "step_ms": [], "launches": dict.fromkeys(
                fa.LAUNCHES, 0), "steps": []}
            with _flash_shapes() as shapes:
                for _ in range(LOCAL_STEPS):
                    torch.cuda.synchronize()
                    C.reset_bytes()
                    fa.reset_launches()
                    timeline.start_steps()
                    t0 = time.perf_counter()
                    loss = step(model, tokens)
                    torch.cuda.synchronize()
                    out["step_ms"].append((time.perf_counter() - t0) * 1e3)
                    legs = timeline.leg_seconds(timeline.stop_steps())
                    out["losses"].append(loss.item())
                    for k, v in fa.LAUNCHES.items():
                        out["launches"][k] += v
                    out["steps"].append(dict(
                        _local_step_record(label, step, legs),
                        gloo_staged_bytes=C.BYTES["staged"]))
            out["flash_shapes"] = sorted(shapes)
            out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
            diff = max((v.float() - ref[k].to(v.device).float()).abs()
                       .max().item() for k, v in model.state_dict().items())
            rel = max(((v.double() - ref[k].to(v.device).double()).abs()
                       / ref[k].to(v.device).double().abs().clamp_min(
                           1e-30)).max().item()
                      for k, v in model.state_dict().items())
            out["params_max_abs_diff"], out["params_max_rel_diff"] = diff, rel
            if label == "distributed_optimizer":
                fa.reset_launches()
                with torch.no_grad(), _flash_shapes() as shapes:
                    logits = model(tokens)
                torch.cuda.synchronize()
                out["eval_launches"] = dict(fa.LAUNCHES)
                out["eval_flash_shapes"] = sorted(shapes)
                out["eval_finite"] = bool(torch.isfinite(logits).all())
                del logits
            if hasattr(step, "close"):
                step.close()
            del model, step
            gc.collect()  # the next path's peak holds no model of this one
            torch.cuda.empty_cache()
            rec["paths"][label] = out
            log(f"local ps host {host} rank {local}: {label} losses "
                f"{out['losses']} ms {[round(x) for x in out['step_ms']]}")
        rec["seconds"] = time.perf_counter() - t_start
        rec["stage_dirs"] = sorted(made_in)
    finally:
        bps.shutdown()
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"host{host}_rank{local}.json"),
              "w") as f:
        json.dump(rec, f)
    return 0


def _local_worker_cmd(tmp, port):
    return [sys.executable, os.path.join(HERE, "chip_smoke.py"),
            "--local-ps-worker", tmp, "--port", str(port)]


def _run_local_fleet(tmp):
    """A scheduler and one server with DMLC_NUM_WORKER = LOCAL_HOSTS, then
    LOCAL_HOSTS hosts, each ``python -m byteps_tpu_torch.launcher
    --workers-per-host LOCAL_SIZE -- python chip_smoke.py
    --local-ps-worker TMP --port P`` with DMLC_WORKER_ID = h, every
    process in a session of its own; waits for all, kills whatever is
    left; returns (the records, the fleet's port)."""
    import signal
    port = _free_port()
    env = dict(os.environ)
    env.update({
        "PYTHONPATH": HERE + os.pathsep + env.get("PYTHONPATH", ""),
        "DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_PS_ROOT_PORT": str(port),
        "DMLC_NUM_WORKER": str(LOCAL_HOSTS), "DMLC_NUM_SERVER": "1",
        "PS_HEARTBEAT_INTERVAL": "1", "BYTEPS_PS_MODE": "ps",
        # a step's pushes within the push budget, as phase 8's
        "BYTEPS_SCHEDULING_CREDIT": str(1 << 30)})
    cmds = [(role, dict(env, DMLC_ROLE=role),
             [sys.executable, "-m", "byteps_tpu_torch.server"])
            for role in ("scheduler", "server")]
    cmds += [(f"host{h}", dict(env, DMLC_ROLE="worker",
                               DMLC_WORKER_ID=str(h)),
              [sys.executable, "-m", "byteps_tpu_torch.launcher",
               "--workers-per-host", str(LOCAL_SIZE), "--",
               *_local_worker_cmd(tmp, _free_port())])
             for h in range(LOCAL_HOSTS)]
    procs = []
    for name, e, cmd in cmds:
        out = open(os.path.join(tmp, f"{name}.log"), "w")
        procs.append((name, out, subprocess.Popen(
            cmd, env=e, cwd=HERE, stdout=out, stderr=subprocess.STDOUT,
            start_new_session=True)))
    deadline = time.monotonic() + LOCAL_TIMEOUT_S
    rcs = {}
    for name, out, p in procs[::-1]:  # the hosts first
        try:
            rcs[name] = p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            rcs[name] = None
    for name, out, p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.wait()
        out.close()
        with open(out.name) as f:
            text = f.read()
        log(f"--- phase 11 {name} (exit {rcs[name]}) ---\n"
            + text[-8000 if rcs[name] != 0 else -1500:])
    if any(rc != 0 for rc in rcs.values()):
        raise AssertionError(f"phase 11 fleet exited {rcs}")
    recs = {}
    for h in range(LOCAL_HOSTS):
        for r in range(LOCAL_SIZE):
            with open(os.path.join(tmp, f"host{h}_rank{r}.json")) as f:
                recs[h * LOCAL_SIZE + r] = json.load(f)
    return recs, port


def local_ps_phase():
    """Phase 11. Multi-GPU-per-host PS: the one-process reference in this
    process (``_local_reference``), freed from the card; then a fleet of
    LOCAL_HOSTS hosts of LOCAL_SIZE ranks, every process on the one card
    (``local_ps_worker``): each host's ranks form a gloo group of their
    own, whose collectives the port stages through host memory, and share
    host staging (``local_stage``; ``df`` of /dev/shm is logged first);
    only local rank 0 of each host holds a core client. Gates, each
    written before the run that first read it:
    - roles: global rank h * 2 + l, size 4, 2 hosts; a client on local
      rank 0 only;
    - the f32 paths (ps, overlap_f32, bucketed_multi,
      distributed_optimizer): every rank's losses equal to the
      reference's for its rows and its parameters equal to the
      reference's, to the bit (two-operand f32 sums commute, dividing by
      2 is exact, and the GPT-2 step repeats to the bit);
    - overlap_bf16: each rank's losses within ``_losses_match``'s bf16
      bound of its reference losses;
    - #1, #3 and #4 launched 12 times a step on every rank and path, #2
      never in training, 12 times (alone) in the evaluation forward;
    - every rank's flash calls, in training and in the evaluation
      forward, have the one q shape [2, 512, 12, 64] of the kernel
      phase's ``gpt2_local_ps`` case, which holds the kernels to their
      plain versions there;
    - every step: each rank copies into the host's staging half of each
      f32 gradient (ceil(n / 2) elements a leaf; the bf16 wire half of
      that), and each root pushes one gradient's bytes (whole leaves on
      the plain path: 4 n; the shards elsewhere, 4 x 2 ceil(n / 2)), the
      others none;
    - each host's root made its segments in a directory it recorded, and
      no staging file of the fleet is left in any of them."""
    import shutil

    df = subprocess.run(["df", "-B1", "/dev/shm"], capture_output=True,
                        text=True).stdout.strip()
    log("phase 11: df /dev/shm\n" + df)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_local_ps_")
    try:
        t0 = time.perf_counter()
        ref_losses, numels = _local_reference(tmp)
        ref_s = time.perf_counter() - t0
        recs, port = _run_local_fleet(tmp)
        fleet_s = time.perf_counter() - t0 - ref_s
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    stage = sorted({d for rec in recs.values() for d in rec["stage_dirs"]})
    left = sorted(os.path.join(d, n) for d in stage for n in os.listdir(d)
                  if n.startswith(f"bps_{port}_"))
    gates = _local_gates(recs, ref_losses, numels, stage, left)
    out = {"df_dev_shm": df, "stage_dirs": stage, "reference_s": ref_s,
           "fleet_s": fleet_s, "reference_losses": ref_losses,
           "gates": gates, "ranks": recs}
    log("phase 11 (two hosts of two ranks, PS):", json.dumps(
        {k: v for k, v in out.items() if k != "ranks"}))
    return out


def _local_gates(recs, ref_losses, numels, stage, left):
    """Phase 11's gates (``local_ps_phase``); returns what they read."""
    half = sum(-(-n // LOCAL_SIZE) for n in numels)
    case = next(c for c in CASES if c[0] == "gpt2_local_ps")
    shape = [[case[1], case[2], case[4], case[5]]]  # b, s_q, h, d
    fails, read = [], {}
    roots = [r for r, rec in recs.items() if rec["stage_dirs"]]
    if sorted(roots) != [h * LOCAL_SIZE for h in range(LOCAL_HOSTS)]:
        fails.append(f"ranks that recorded a staging directory: {roots}, "
                     "expected each host's root")
    if left:
        fails.append(f"staging files left in {stage}: {left}")
    for r, rec in sorted(recs.items()):
        want = (r, LOCAL_HOSTS * LOCAL_SIZE, LOCAL_HOSTS,
                rec["local_rank"] == 0)
        got = (rec["rank"], rec["size"], rec["hosts"], rec["client"])
        if got != want:
            fails.append(f"rank {r}: (rank, size, hosts, client) {got}, "
                         f"expected {want}")
        for label, wire in LOCAL_PATHS.items():
            out = rec["paths"][label]
            try:
                _check_launches(f"phase 11 rank {r} {label}",
                                out["launches"], GPT2.layers, LOCAL_STEPS)
                if out["flash_shapes"] != shape:
                    raise AssertionError(f"flash shapes "
                                         f"{out['flash_shapes']} != {shape}")
                if wire == "float32":
                    if out["losses"] != ref_losses[r]:
                        raise AssertionError(
                            f"losses {out['losses']} != reference "
                            f"{ref_losses[r]}")
                    if out["params_max_abs_diff"] != 0:
                        raise AssertionError(
                            f"parameters {out['params_max_abs_diff']} "
                            "from the reference's")
                else:
                    _losses_match(f"rank {r} {label}", out["losses"],
                                  ref_losses[r], wire)
                elem = 2 if wire == "bfloat16" else 4
                staged = elem * half
                pushed = (4 * sum(numels) if label == "ps"
                          else 4 * LOCAL_SIZE * half)
                for s in out["steps"]:
                    if s["d2h_bytes"] != staged:
                        raise AssertionError(f"staged {s['d2h_bytes']} "
                                             f"bytes, expected {staged}")
                    want_push = pushed if rec["local_rank"] == 0 else 0
                    if s["pushed_bytes"] != want_push:
                        raise AssertionError(
                            f"pushed {s['pushed_bytes']} bytes, expected "
                            f"{want_push}")
            except AssertionError as e:
                fails.append(f"rank {r} {label}: {e}")
        ev = rec["paths"]["distributed_optimizer"]
        try:
            _check_eval_launches(f"phase 11 rank {r}", ev["eval_launches"],
                                 GPT2.layers)
            if ev["eval_flash_shapes"] != shape:
                raise AssertionError(f"evaluation flash shapes "
                                     f"{ev['eval_flash_shapes']} != {shape}")
            if not ev["eval_finite"]:
                raise AssertionError("non-finite evaluation logits")
        except AssertionError as e:
            fails.append(f"rank {r}: {e}")
    read["grad_bytes"] = 4 * sum(numels)
    read["staged_bytes_f32"] = 4 * half
    read["medians"] = {label: {
        "step_ms": [_median(recs[r]["paths"][label]["step_ms"])
                    for r in sorted(recs)],
        "split_ms": {leg: [_median([s["split_s"][leg] * 1e3 for s in
                                    recs[r]["paths"][label]["steps"]])
                           for r in sorted(recs)]
                     for leg in ("reduce_scatter", "d2h", "core", "h2d",
                                 "all_gather")},
        "exposed_ms": [_median([s.get("exposed_ms", 0.0) for s in
                                recs[r]["paths"][label]["steps"]])
                       for r in sorted(recs)],
        "gloo_staged_bytes": recs[0]["paths"][label]["steps"][-1][
            "gloo_staged_bytes"],
        "peak_memory_gb": [recs[r]["paths"][label]["peak_memory_gb"]
                           for r in sorted(recs)],
        "params_max_abs_diff": [recs[r]["paths"][label][
            "params_max_abs_diff"] for r in sorted(recs)]}
        for label in LOCAL_PATHS}
    if fails:
        raise AssertionError("phase 11 failed:\n" + "\n".join(fails))
    return read


# --- phase 12: GPT-2 medium under the C core's onebit and topk codecs -------

ONEBIT = "type=onebit;ef=vanilla"
TOPK = "type=topk;ef=vanilla"  # the core's default k: 1 % of each partition
# run -> (BYTEPS_COMPRESSOR of its fleet, the paths it runs in turns,
# steps a path); ps_bf16 is the plain step with Compression.bf16 (the
# wire of BASELINE's 345M chip bench), dense runs it as the reference of
# onebit_bf16. Fewer steps than STEPS: a codec step takes 5-9 s of the
# core's host codecs (PERF.md, PR 11); the runs that compare paths or
# carry the loss bound's reference take 3, topk and onebit_bf16 2.
CODEC_RUNS = {
    "dense": ("", ("ps", "ps_bf16"), 3),
    "onebit": (ONEBIT, ("ps", "overlap_f32", "bucketed_multi",
                        "distributed_optimizer"), 3),
    "topk": (TOPK, ("ps",), 2),
    "onebit_bf16": (ONEBIT, ("ps_bf16",), 2),
}
CODEC_LR, CODEC_GAMMA = 1e-4, 0.5
# GPT-2 medium at full width with 12 of its 24 layers: at 24 layers the
# phase took 285 s (4 steps) and 240 s (3 steps) of the script's 1200,
# the codecs' host passes scaling with the parameters (PERF.md, PR 11)
CODEC_LAYERS = 12
CODEC_LOSS_CAP = 2.5  # tests/test_examples.py's dense + 2.5, the loosest


def _codec_path(label, base, lm):
    """A copy of ``base`` (``lm``, seed-0 weights), _ps_path's AdamW and a
    StepLR(1, CODEC_GAMMA) stepped after every step, through the PS path
    ``label`` (its tensors under a prefix of its own, so each path keeps
    its own error feedback). The DistributedOptimizer is the reference
    plugin's usage: named_parameters, the scheduler around the wrapped
    optimizer. Returns (model, step)."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.bucketed import make_bucketed_overlap_step
    from byteps_tpu_torch.overlap import make_overlapped_train_step
    from byteps_tpu_torch.training import make_train_step

    model = copy.deepcopy(base)
    opt = torch.optim.AdamW(model.parameters(), lr=CODEC_LR,
                            weight_decay=1e-4)
    if label in ("ps", "ps_bf16"):
        inner = make_train_step(
            lm.loss, opt, ps_prefix=f"codec_{label}",
            compression=(bps.Compression.bf16 if label == "ps_bf16"
                         else bps.Compression.none))
    elif label == "overlap_f32":
        inner = make_overlapped_train_step(lm.loss, opt, prefix=label)
    elif label == "bucketed_multi":
        inner = make_bucketed_overlap_step(lm.loss, opt, prefix=label,
                                           multi_program=True)
    else:
        opt = bps.DistributedOptimizer(
            opt, named_parameters=model.named_parameters())

        def inner(model, tokens):
            opt.zero_grad()
            loss = lm.loss(model, tokens)
            loss.backward()
            opt.step()
            return loss.detach()
        inner.close = opt._taps.close
    sched = torch.optim.lr_scheduler.StepLR(opt, 1, gamma=CODEC_GAMMA)

    def step(model, tokens):
        loss = inner(model, tokens)
        sched.step()
        return loss
    step.close = getattr(inner, "close", None)
    step.lr = lambda: opt.param_groups[0]["lr"]
    return model, step


def _codec_fleet(run, base, lm, evaluate=False):
    """The steps of each path of ``run`` (CODEC_RUNS) in turns, from copies
    of ``base``, in a fleet of
    its own whose every role has the run's BYTEPS_COMPRESSOR: per step
    its loss, host ms, the wire bytes each way (the root client's
    ``net_bytes()`` around the step), the flash launches (counts set to
    0 just before the step, read just after) and, for the plain step,
    the D2H / core / H2D split of its legs (``timeline.leg_seconds``);
    with ``evaluate``, then one evaluation forward of the first path's
    model."""
    import gc

    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.utils import timeline
    fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")

    codec, labels, steps = CODEC_RUNS[run]
    with _fleet({"BYTEPS_COMPRESSOR": codec}):
        bps.init()
        try:
            tokens = lm.batch(bps.device())
            torch.cuda.reset_peak_memory_stats()
            paths = {label: _codec_path(label, base, lm)
                     for label in labels}
            client = bps._st().ps_client
            rec = {label: {"losses": [], "step_ms": [], "sent": [],
                           "received": [], "staging": [], "lr": [],
                           "launches": dict.fromkeys(fa.LAUNCHES, 0)}
                   for label in labels}
            torch.cuda.synchronize()
            for r in range(steps):
                for label in labels[r % len(labels):] + labels[
                        :r % len(labels)]:
                    model, step = paths[label]
                    out = rec[label]
                    out["lr"].append(step.lr())
                    sent, received = client.net_bytes()
                    fa.reset_launches()
                    if label.startswith("ps"):
                        timeline.start_steps()
                    t0 = time.perf_counter()
                    loss = step(model, tokens)
                    torch.cuda.synchronize()
                    out["step_ms"].append((time.perf_counter() - t0) * 1e3)
                    for k, v in fa.LAUNCHES.items():
                        out["launches"][k] += v
                    now = client.net_bytes()
                    out["sent"].append(now[0] - sent)
                    out["received"].append(now[1] - received)
                    out["losses"].append(loss.item())
                    if label.startswith("ps"):
                        out["staging"].append(
                            {k: v * 1e3 for k, v in timeline.leg_seconds(
                                timeline.stop_steps()).items()
                             if k.endswith("_s")})
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            if evaluate:
                evaluation = dict(zip(
                    ("eval_launches", "eval_flash_vs_plain_max_abs_err"),
                    _evaluate(lm, paths[labels[0]][0], tokens,
                              tokens[:2, :128])))
            for _, step in paths.values():
                if step.close is not None:
                    step.close()
            del paths, model, step, tokens
        finally:
            bps.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    for label, out in rec.items():
        _check_launches(f"{run} {label}", out["launches"], lm.layers,
                        steps)
        if not all(math.isfinite(x) for x in out["losses"]):
            raise AssertionError(f"{run} {label}: non-finite losses "
                                 f"{out['losses']}")
        out.update(
            peak_memory_gb=peak_gb, median_step_ms=_median(out["step_ms"]),
            sent_per_step=_median(out["sent"]),
            received_per_step=_median(out["received"]),
            flash_launches_per_step={k: v / steps
                                     for k, v in out["launches"].items()})
        if out["staging"]:
            out["staging_ms"] = {
                k: _median([s[k] for s in out["staging"]])
                for k in ("d2h_s", "core_s", "h2d_s")}
        log(f"codec {run} {label}: losses {out['losses']} step ms "
            f"{[round(x, 1) for x in out['step_ms']]} bytes sent "
            f"{out['sent']} received {out['received']}"
            + (f" D2H/core/H2D ms {out['staging_ms']}"
               if out["staging"] else ""))
    return {"paths": rec, **(evaluation if evaluate else {})}


def _adam_ratio_bounds(steps, b1=0.9, b2=0.999):
    """c_s, s = 1..steps: the most |m_hat / sqrt(v_hat)| of AdamW's
    update s can be, whatever the gradients (Cauchy-Schwarz over the
    bias-corrected averages: sqrt(sum_i a_i^2 / b_i) with a_i, b_i the
    weights of gradient i in m_hat and v_hat)."""
    out = []
    for s in range(1, steps + 1):
        a = [(1 - b1) * b1 ** (s - i) / (1 - b1 ** s)
             for i in range(1, s + 1)]
        b = [(1 - b2) * b2 ** (s - i) / (1 - b2 ** s)
             for i in range(1, s + 1)]
        out.append(math.sqrt(sum(x * x / y for x, y in zip(a, b))))
    return out


def _codec_loss_bounds(dense, lrs):
    """How far a lossy run's loss after step t may sit from the dense
    run's (``dense``: (a)'s f32 losses; ``lrs``: the lr of each step).

    Every run is AdamW from the same weights, so update s moves each
    weight by at most lr_s * c_s (``_adam_ratio_bounds``; the weight
    decay's lr_s * 1e-4 * |w| is below 1e-8 of that) whatever gradients
    the codec hands it. To first order a run's loss then moves from L_1
    by at most |g_1|_1 * sum_{s<t} lr_s c_s, with g_1 the step-1 gradient
    (the same in every run: same weights, same tokens). AdamW's first
    update is lr_1 * sign(g_1), the steepest move in that box, so the
    dense run's first drop D = L_1 - L_2 is |g_1|_1 lr_1 to first order.
    Hence |L_t - L_1| <= D * sum_{s<t} (lr_s / lr_1) c_s for any run; the
    bound doubles that for the curvature the first order leaves out and
    adds the dense run's own distance |L_t^dense - L_1|, and is capped at
    CODEC_LOSS_CAP. Step 1 has bound 0: it must equal the dense loss to
    the bit."""
    c = _adam_ratio_bounds(len(dense))
    drop = abs(dense[0] - dense[1])
    bounds = [0.0]
    for t in range(1, len(dense)):
        box = sum(lrs[s] / lrs[0] * c[s] for s in range(t))
        bounds.append(min(CODEC_LOSS_CAP,
                          2 * drop * box + abs(dense[t] - dense[0])))
    return bounds


def codec_phase():
    """Phase 12 (BASELINE config 3, GPT-2 345M with the onebit / topk
    codecs). GPT2Medium(flash) at full width, CODEC_LAYERS of its 24
    layers, seed-0 weights,
    phase 3's 8 x 512 tokens, AdamW(1e-4, weight decay 1e-4) with
    StepLR(1, 0.5), 3 steps of each path (2 in (c) and (d)), one worker
    and one server, each run in a fleet of its own (CODEC_RUNS): (a) dense: the
    plain step on the f32 and on the bf16 wire; (b) onebit + EF: the
    plain step, overlap_f32, bucketed_multi and the DistributedOptimizer
    (named_parameters, the scheduler around it) in turns; (c) topk + EF
    at the core's default k; (d) onebit + EF under the bf16 wire.

    Gates: (b)'s bytes each way under 1/8 of (a)'s f32 run's, (c)'s sent
    under 1/2 of it, (d)'s each way under 1/8 of (a)'s bf16 run's; every
    path's step-1 loss equal to (a)'s to the bit, every loss finite, the
    later losses of (b), (c) and (d) within ``_codec_loss_bounds`` of
    (a)'s; the four paths of (b) equal to each other to the bit (each
    sums the same gradient under the same codec with error feedback of
    its own, and the servers' reply is decoded alike); the launch counts
    of every path and of each run's evaluation forward."""
    import functools

    import torch
    lm = GPT2M._replace(make=functools.partial(GPT2M.make,
                                               num_layers=CODEC_LAYERS),
                        layers=CODEC_LAYERS)
    base = lm.make()
    runs = {run: _codec_fleet(run, base, lm, evaluate=run == "onebit")
            for run in CODEC_RUNS}
    del base
    torch.cuda.empty_cache()
    dense = runs["dense"]["paths"]
    ref, ref_bf16 = dense["ps"], dense["ps_bf16"]
    bounds = _codec_loss_bounds(ref["losses"], ref["lr"])
    failures = []

    def gate(ok, what):
        if not ok:
            failures.append(what)
    for run, out in runs.items():
        for label, p in out["paths"].items():
            gate(p["losses"][0] == ref["losses"][0],
                 f"{run} {label}: step-1 loss {p['losses'][0]!r} != dense "
                 f"{ref['losses'][0]!r}")
            if run == "dense":
                continue
            for t, (a, b) in enumerate(zip(p["losses"], ref["losses"])):
                gate(abs(a - b) <= bounds[t],
                     f"{run} {label}: loss {a} at step {t + 1} is "
                     f"{abs(a - b):.4g} from dense {b} (bound {bounds[t]:.4g})")
    for label, p in runs["onebit"]["paths"].items():
        gate(p["sent_per_step"] * 8 < ref["sent_per_step"]
             and p["received_per_step"] * 8 < ref["received_per_step"],
             f"onebit {label}: {p['sent_per_step']} / "
             f"{p['received_per_step']} bytes a step against dense "
             f"{ref['sent_per_step']} / {ref['received_per_step']}")
        gate(p["losses"] == runs["onebit"]["paths"]["ps"]["losses"],
             f"onebit {label}: losses {p['losses']} != the plain step's "
             f"{runs['onebit']['paths']['ps']['losses']}")
    topk = runs["topk"]["paths"]["ps"]
    gate(topk["sent_per_step"] * 2 < ref["sent_per_step"],
         f"topk: {topk['sent_per_step']} bytes sent a step against dense "
         f"{ref['sent_per_step']}")
    half = runs["onebit_bf16"]["paths"]["ps_bf16"]
    gate(half["sent_per_step"] * 8 < ref_bf16["sent_per_step"]
         and half["received_per_step"] * 8 < ref_bf16["received_per_step"],
         f"onebit_bf16: {half['sent_per_step']} / "
         f"{half['received_per_step']} bytes a step against dense bf16 "
         f"{ref_bf16['sent_per_step']} / {ref_bf16['received_per_step']}")
    summary = {run: {label: {k: p[k] for k in (
        "median_step_ms", "sent_per_step", "received_per_step",
        "flash_launches_per_step", "peak_memory_gb", "losses", "step_ms",
        "staging_ms") if k in p} for label, p in out["paths"].items()}
        for run, out in runs.items()}
    evaluation = {k: v for k, v in runs["onebit"].items() if k != "paths"}
    log("GPT-2 medium codec runs (median of steps 2 on; bytes a step; loss "
        "bounds " + json.dumps(bounds) + "):", json.dumps(summary),
        json.dumps(evaluation))
    if failures:
        raise AssertionError("codec phase failed:\n" + "\n".join(failures))
    return {"runs": summary, "loss_bounds": bounds, **evaluation,
            "launches": {**runs["onebit"]["paths"]["ps"]["launches"],
                         "fwd": evaluation["eval_launches"]["fwd"]}}


# --- phase 13: GPT-2 small in f32 --------------------------------------------

F32_STEPS = 3
# limit()'s f32 terms: the final rounding (eps) and 1e-4 of the magnitude
# of the terms behind an element
F32_REL = 2.0 ** -23 + 1e-4


def _f32_logit_bound(layers, logits):
    """Bound on max |flash - full| of the f32 logits of one set of weights:
    each layer's attention output may move by limit()'s f32 terms, eps +
    1e-4 of the terms behind it, and the bound carries each layer's share
    to the logits at unit gain, relative to their magnitude: layers x (eps
    + 1e-4) x max |logits|. Not fitted: the kernels' own error (three TF32
    products, ~2^-21 a term, and f32 sums in another order) sits far
    below those terms."""
    return layers * F32_REL * logits.abs().max().item()


def f32_phase():
    """13. GPT2Small(dtype=float32, attn_impl="flash") at full width
    (seed-0 weights, phase 3's 8 x 512 tokens): F32_STEPS collective
    make_train_step steps with AdamW(1e-4, wd 1e-4), the forward with lse,
    dQ and dK/dV 12 times a step (the f32 kernels); step 1's loss equal to
    the same weights' under attn_impl="full" in f32 within twice
    ``_f32_logit_bound`` (a loss, lse(z) - z_target, moves by at most
    twice its logits' max change); an evaluation forward (the forward
    without lse 12 times) whose logits agree with the trained weights
    under plain attention within ``_f32_logit_bound``; a profiled step.
    f32 matrix products outside the kernels stay in full f32."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import lm_loss
    fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("torch.backends.cuda.matmul.allow_tf32 is set")
    os.environ["BYTEPS_PS_MODE"] = "collective"
    bps.init()
    try:
        tokens = GPT2.batch(bps.device())
        ref = GPT2.make("full", dtype=torch.float32)
        with torch.no_grad():
            want = ref(tokens)
            ref_loss = lm_loss(want, tokens).item()
            loss_bound = 2 * _f32_logit_bound(GPT2.layers, want)
        del want
        model, step, _, losses, times, _, launches, peak_gb = _train(
            "f32", GPT2, steps=F32_STEPS, dtype=torch.float32)
        if not abs(losses[0] - ref_loss) <= loss_bound:
            raise AssertionError(f"f32: step-1 loss {losses[0]} against "
                                 f"plain attention's {ref_loss} (bound "
                                 f"{loss_bound})")
        fa.reset_launches()
        with torch.no_grad():
            logits = model(tokens)
        torch.cuda.synchronize()
        eval_launches = dict(fa.LAUNCHES)
        _check_eval_launches("f32", eval_launches, GPT2.layers)
        if (tuple(logits.shape) != (*tokens.shape, GPT2.vocab)
                or not bool(torch.isfinite(logits).all())):
            raise AssertionError("f32 evaluation logits: bad shape or "
                                 "values")
        ref.load_state_dict(model.state_dict())
        with torch.no_grad():
            want = ref(tokens)
        logit_err = (logits - want).abs().max().item()
        logit_bound = _f32_logit_bound(GPT2.layers, want)
        del ref, logits, want
        if not logit_err <= logit_bound:
            raise AssertionError(f"f32: flash vs plain attention logits "
                                 f"differ by {logit_err} (bound "
                                 f"{logit_bound})")
        profile = _profile_lm("f32", step, model, tokens, times,
                              kernels=F32_KERNELS)
        del model, step
    finally:
        bps.shutdown()
    torch.cuda.empty_cache()
    flash_ms = sum(profile["flash_kernel_ms"].values())
    out = {"losses": losses, "step_ms": times,
           "median_step_ms": _median(times), "peak_gb": peak_gb,
           "launches": {**launches, "fwd": eval_launches["fwd"]},
           "step1_loss_plain_attention": ref_loss,
           "step1_loss_err": abs(losses[0] - ref_loss),
           "step1_loss_bound": loss_bound, "logit_max_abs_err": logit_err,
           "logit_bound": logit_bound, "flash_ms": flash_ms,
           "flash_share_of_device_ms": flash_ms / profile["device_ms"],
           "profile": profile}
    log("phase 13 (GPT-2 small, f32):", json.dumps(
        {k: v for k, v in out.items() if k != "profile"}))
    return out


# --- main ---------------------------------------------------------------------

REPLACES = {
    # name: (bf16/f16 kernel, f32 kernel, the TPU kernel)
    "fwd_lse": ("fa_fwd_wgmma_kernel<T,D,true>", "fa_fwd_tf32_kernel<D,true>",
                "byteps_tpu/ops/flash_attention.py:253"),
    "fwd": ("fa_fwd_wgmma_kernel<T,D,false>", "fa_fwd_tf32_kernel<D,false>",
            "byteps_tpu/ops/flash_attention.py:277"),
    "bwd_dq": ("fa_bwd_dq_wgmma_kernel<T,D>", "fa_bwd_dq_tf32_kernel<D>",
               "byteps_tpu/ops/flash_attention.py:463"),
    "bwd_dkv": ("fa_bwd_dkv_wgmma_kernel<T,D>", "fa_bwd_dkv_tf32_kernel<D>",
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
    reference, reference_cases = reference_phase()
    coll_losses, coll_times, coll_launches, profile = collective_phase()
    # phase 9 runs here, while this process holds little of the card: its
    # two processes need 27 GB each, and after phases 4-8 this process
    # kept enough that they ran out of memory
    sp = sp_phase(coll_losses)
    # phase 10 too, before phases 4-8 leave memory held in this process
    par = par_phase()
    # and phase 11, whose four processes share the card
    local = local_ps_phase()
    # phase 12, while this process still holds little of the card: the
    # onebit fleet holds four GPT-2 medium models with their AdamW state
    codec = codec_phase()
    f32 = f32_phase()
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
        "parallel": par,
        "local_ps": local,
        "codec": codec,
        "gpt2_small_f32": f32,
        "memory_held_after_phase8_gb": held_gb,
        "sdpa_fwd_bwd_ms": {case: timing[case]["sdpa_fwd_bwd_ms"]
                            for case in TIMED},
        "bwd_pair": {case: timing[case]["bwd_pair"] for case in TIMED},
        "kernel_errors": errors,
        "kernel_readings": timing["readings"],
        "kernel_reference_ratios": reference_cases,
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
               "gpt2_int8_rank0": sp["ranks"][0]["d"]["int8"]["launches"],
               # rank 0 of phase 10's pair: (a) two TP passes, and for fwd
               # its evaluation forward; (b) each schedule; (c) ZeRO's steps
               "gpt2m_tp2_rank0": {
                   **par["ranks"][0]["a"]["launches"],
                   "fwd": par["ranks"][0]["a"]["eval_launches"]["fwd"]},
               "gpt2m_1f1b_rank0": par["ranks"][0]["b"]["1f1b"]["launches"],
               "gpt2m_gpipe_rank0": par["ranks"][0]["b"]["gpipe"]["launches"],
               "gpt2m_zero_rank0": par["ranks"][0]["c"]["zero"]["launches"],
               # global rank 0 of phase 11's fleet: the plain PS step's
               # training steps, and for fwd the evaluation forward
               "gpt2_local_ps_rank0": {
                   **local["ranks"][0]["paths"]["ps"]["launches"],
                   "fwd": local["ranks"][0]["paths"][
                       "distributed_optimizer"]["eval_launches"]["fwd"]},
               # phase 12's onebit fleet: the plain step's training steps,
               # and for fwd the evaluation forward
               "gpt2_medium_onebit": codec["launches"],
               # phase 13: training steps, and for fwd its evaluation
               # forward
               "gpt2_small_f32": f32["launches"]}
    kernels = []
    for name, (fn, fn_f32, replaces) in REPLACES.items():
        kernels.append({
            "name": f"flash_attention.{name} ({fn} | {fn_f32})",
            "route": "cuda",
            "source": "byteps_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces, "launches": coll_launches[name],
            "max_abs_err": errors[name]["gpt2"], **timing["gpt2"][name],
            # worst |err| / (atol + rtol |want|) at the JAX tests' bounds
            # (the bf16 case reaches the forwards only)
            "reference_ratio": reference[name].get("bfloat16"),
            # the f32 kernel at GPT-2's shape and on phase 13's path
            "f32": {"function": fn_f32, "launches": f32["launches"][name],
                    "max_abs_err": errors[name]["gpt2_f32"],
                    "reference_ratio": reference[name]["float32"],
                    **timing["gpt2_f32"][name]},
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
    p.add_argument("--par-worker", metavar="DIR")
    p.add_argument("--local-ps-worker", metavar="DIR")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--port", type=int, default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    if args.sp_worker:
        return sp_worker(args.sp_worker, args.rank, args.port)
    if args.par_worker:
        return par_worker(args.par_worker, args.rank, args.port)
    if args.local_ps_worker:
        return local_ps_worker(args.local_ps_worker, args.port)
    return launched_worker(args.launched_worker, args.preempt_after,
                           args.trace)


if __name__ == "__main__":
    if {"--launched-worker", "--sp-worker", "--par-worker",
            "--local-ps-worker"} & set(sys.argv[1:]):
        sys.exit(_worker_main(sys.argv[1:]))
    sys.exit(main())
