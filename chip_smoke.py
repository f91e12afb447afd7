#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (byteps_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. build: the flash-attention kernels (nvcc, sm_90a) and the C++ PS core
   (g++), both from this checkout's sources, in parallel, into
   build/byteps_tpu_torch/;
2. kernels: each of the four CUDA kernels against its plain PyTorch
   version on the card, at GPT-2 small's attention shapes (b 8, s 512,
   h 12, d 64, bf16, causal) and on an unaligned f32 case (s 600), a
   rectangular causal case (100 x 260) and a sliding-window case (s 300,
   window 64); each timed beside its plain version, PyTorch's
   scaled_dot_product_attention, and its bound;
3. collective mode: GPT2Small(attn_impl="flash") at full width trains a
   few steps of 8 x 512 tokens through init -> make_train_step with
   AdamW, then runs one evaluation forward under no_grad; the launch
   counts show every kernel ran on that path, and the flash model's
   logits agree with the same weights under plain attention;
4. PS mode: a scheduler and one CPU server (python -m
   byteps_tpu_torch.server) as child processes, this process as worker 0,
   the same steps from the same weights; the losses must equal phase 3's.

Stdout ends with the kernels line, the card's name and power limit, and
{"ok": true, "device": {...}}. Exits non-zero, with no result, when CUDA
is not available or any phase fails.
"""

from __future__ import annotations

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


# --- phase 2: kernels against their plain versions ---------------------------

def _time_ms(fn, iters=20, warmup=3):
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


def _bound_ms(name, b, h, s_q, s_k, d, elem, causal, window, dtype):
    """Least time on the card: bytes read once and written once at the HBM
    rate against the matrix-product operations at the peak of the dtype
    (exp and the rest are not counted)."""
    q_bytes, kv_bytes = b * s_q * h * d * elem, b * s_k * h * d * elem
    row_bytes = b * h * s_q * 4  # one f32 per query row (lse, D)
    pairs = b * h * _live_pairs(s_q, s_k, causal, window)
    if name == "fwd_lse":
        nbytes, ops = 2 * q_bytes + 2 * kv_bytes + row_bytes, 4 * d * pairs
    elif name == "fwd":
        nbytes, ops = 2 * q_bytes + 2 * kv_bytes, 4 * d * pairs
    elif name == "bwd_dq":
        nbytes, ops = 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes, \
            6 * d * pairs
    else:  # bwd_dkv
        nbytes, ops = 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes, \
            8 * d * pairs
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def limit(dtype, what, got, want, mag):
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
    - 1e-6, so an element that is 0 on both sides has a limit."""
    import torch
    if what == "lse":
        return 1e-5 + 1e-5 * want.abs()
    eps = torch.finfo(getattr(torch, dtype)).eps
    rounded = dtype != "float32" and what in ("o", "dq", "dk")
    return (1e-6 + eps * torch.maximum(got.abs(), want.abs())
            + ((eps if rounded else 0.0) + 1e-4) * mag)


def compare(dtype, what, got, want, mag):
    """(max abs error, worst ratio of error to its element's limit,
    finite): the check passes when the ratio is at most 1."""
    import torch
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    ratio = (diff / limit(dtype, what, got, want, mag)).max().item()
    return diff.max().item(), ratio, bool(torch.isfinite(got).all())


CASES = [
    # name, b, s_q, s_k, h, d, dtype, causal, window
    ("gpt2", BATCH, SEQ, SEQ, 12, 64, "bfloat16", True, None),
    ("unaligned_f32", 1, 600, 600, 2, 32, "float32", True, None),
    ("rect_causal", 1, 100, 260, 2, 16, "float32", True, None),
    ("window64", 1, 300, 300, 2, 16, "float32", True, 64),
]


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
                                             mag.get(what))
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

        if case != "gpt2":
            continue
        # Times at the main path's shapes: kernel, plain version, and
        # PyTorch's SDPA (forward; backward of all three gradients).
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
        with torch.no_grad():
            sdpa_fwd = _time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt_, vt, is_causal=True))
        qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt_, vt))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        gout = do.transpose(1, 2)
        sdpa_bwd = _time_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), gout, retain_graph=True))

        def sdpa_fwd_bwd():
            o_ = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
            torch.autograd.grad(o_, (qg, kg, vg), gout)
        sdpa_both = _time_ms(sdpa_fwd_bwd)
        library = {"fwd_lse": sdpa_fwd, "fwd": sdpa_fwd,
                   "bwd_dq": sdpa_bwd, "bwd_dkv": sdpa_bwd}
        for kname in kt:
            bound, by = _bound_ms(kname, b, h, s_q, s_k, d, elem, causal,
                                  window, dtype)
            ms = _time_ms(kt[kname])
            report[kname] = {
                "ms": ms, "kernel_ms": ms,
                "plain_ms": _time_ms(pt[kname], iters=5, warmup=1),
                "bound_ms": bound, "bound_by": by,
                "library_ms": library[kname],
            }
        report["sdpa_fwd_bwd_ms"] = sdpa_both
        del out, qg, kg, vg
    if failures:
        raise AssertionError("kernel phase failed:\n" + "\n".join(failures))
    report["readings"] = readings
    return errors, report


# --- phases 3 and 4: the main path -------------------------------------------

def _tokens(device):
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    return torch.from_numpy(
        rng.integers(0, 50257, size=(BATCH, SEQ)).astype(np.int64)).to(device)


def _model(attn_impl="flash"):
    import torch

    from byteps_tpu_torch.models import GPT2Small
    return GPT2Small(attn_impl=attn_impl,
                     generator=torch.Generator().manual_seed(0))


def _loss_fn(model, tokens):
    from byteps_tpu_torch.models import lm_loss
    return lm_loss(model(tokens), tokens)


def _train(label):
    """init -> model -> make_train_step -> STEPS steps, launches counted
    from zero over exactly the training steps."""
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch import ps
    from byteps_tpu_torch.training import make_train_step
    fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")

    model = _model()
    bps.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)
    step = make_train_step(_loss_fn, opt)
    tokens = _tokens(bps.device())
    torch.cuda.synchronize()
    losses, times, staging = [], [], []
    fa.reset_launches()
    for _ in range(STEPS):
        t0 = time.perf_counter()
        loss = step(model, tokens)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        staging.append(dict(ps.last_timings))
    launches = dict(fa.LAUNCHES)
    for name, want in (("fwd_lse", 12 * STEPS), ("bwd_dq", 12 * STEPS),
                       ("bwd_dkv", 12 * STEPS), ("fwd", 0)):
        if launches[name] != want:
            raise AssertionError(f"{label}: {name} launched "
                                 f"{launches[name]} times, expected {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: non-finite losses {losses}")
    log(f"{label}: losses {losses} step ms {[round(t, 1) for t in times]}")
    return model, step, tokens, losses, times, staging, launches


def _profile_step(step, model, tokens):
    """One more training step under torch.profiler: device time by kernel
    family. The profiler slows the host, so its wall time is reported
    beside the busy time and the idle share is taken against the
    unprofiled step time by the caller."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(model, tokens)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for ev in prof.events():
        # device-side events, without the ranges that record_function
        # annotations (Optimizer.step#AdamW.step, ...) mirror there
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and "#" not in ev.name):
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us())
    families = {"flash_attention": 0.0, "matmul": 0.0, "other": 0.0}
    for name, us in by_name.items():
        low = name.lower()
        if "fa_fwd_kernel" in name or "fa_bwd_" in name:
            families["flash_attention"] += us
        elif any(k in low for k in ("gemm", "cutlass", "xmma", "nvjet")):
            families["matmul"] += us
        else:
            families["other"] += us
    busy = sum(families.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"profiled_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "family_ms": {k: v / 1e3 for k, v in families.items()},
            "top_kernels_ms": {k[:80]: v / 1e3 for k, v in top}}


def collective_phase():
    import torch

    import byteps_tpu_torch as bps
    fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")

    os.environ["BYTEPS_PS_MODE"] = "collective"
    bps.init()
    try:
        model, step, tokens, losses, times, _, launches = _train(
            "collective")
        # evaluation forward: the forward kernel without lse, 12 launches
        fa.reset_launches()
        with torch.no_grad():
            logits = model(tokens)
        torch.cuda.synchronize()
        eval_launches = dict(fa.LAUNCHES)
        if eval_launches != {"fwd_lse": 0, "fwd": 12, "bwd_dq": 0,
                             "bwd_dkv": 0}:
            raise AssertionError(f"evaluation launches {eval_launches}")
        if (tuple(logits.shape) != (BATCH, SEQ, 50257)
                or not bool(torch.isfinite(logits).all())):
            raise AssertionError("evaluation logits: bad shape or values")
        launches["fwd"] = eval_launches["fwd"]
        # the same trained weights under plain attention, on a small input
        ref = _model("full")
        ref.load_state_dict(model.state_dict())
        small = tokens[:2, :128]
        with torch.no_grad():
            got, want = model(small), ref(small)
        err = (got - want).abs().max().item()
        # bf16 attention outputs may differ by an ulp, which the residual
        # stream carries to the logits (order 1): 0.1 absolute
        if err > 0.1:
            raise AssertionError(f"flash vs plain attention logits differ "
                                 f"by {err}")
        log(f"flash vs plain-attention logits max_abs_err {err:.3e}")
        del ref, logits
        # the breakdown PERF.md reports: a profiler that fails, or sees no
        # device time, fails the run
        profile = _profile_step(step, model, tokens)
        if not profile["family_ms"]["flash_attention"] > 0:
            raise AssertionError(f"profile shows no flash-attention "
                                 f"device time: {profile}")
        step_ms = sorted(times[1:])[len(times[1:]) // 2]
        profile["idle_share"] = 1.0 - profile["device_busy_ms"] / step_ms
        log("collective step profile:", json.dumps(profile))
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


def ps_phase(collective_losses):
    import torch

    import byteps_tpu_torch as bps

    env = dict(os.environ)
    env.update({
        "DMLC_PS_ROOT_URI": "127.0.0.1",
        "DMLC_PS_ROOT_PORT": str(_free_port()),
        "DMLC_NUM_WORKER": "1",
        "DMLC_NUM_SERVER": "1",
        "PS_HEARTBEAT_INTERVAL": "1",
        "BYTEPS_PS_MODE": "ps",
        "PYTHONPATH": HERE + os.pathsep + env.get("PYTHONPATH", ""),
    })
    logdir = tempfile.mkdtemp(prefix="chip_smoke_ps_")
    children = []
    for role in ("scheduler", "server"):
        out = open(os.path.join(logdir, f"{role}.log"), "w")
        children.append((role, out, subprocess.Popen(
            [sys.executable, "-m", "byteps_tpu_torch.server"],
            env=dict(env, DMLC_ROLE=role), cwd=HERE, stdout=out,
            stderr=subprocess.STDOUT)))
    os.environ.update(env)
    os.environ.update({"DMLC_ROLE": "worker", "DMLC_WORKER_ID": "0"})
    try:
        bps.init()
        try:
            if (bps.rank(), bps.size()) != (0, 1):
                raise AssertionError(f"PS rank/size {bps.rank()}/"
                                     f"{bps.size()}")
            model, _, _, losses, times, staging, launches = _train("ps")
            del model
        finally:
            bps.shutdown()
        for role, out, p in children:
            p.wait(timeout=60)
            if p.returncode != 0:
                raise AssertionError(f"{role} exited {p.returncode}")
    finally:
        for role, out, p in children:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
            with open(out.name) as f:
                tail = f.read()[-2000:]
            if p.returncode != 0 and tail:
                log(f"--- {role} log ---\n{tail}")
    torch.cuda.empty_cache()
    for a, b in zip(losses, collective_losses):
        if abs(a - b) > 1e-5 * abs(b):
            raise AssertionError(f"PS losses {losses} != collective "
                                 f"{collective_losses} (rtol 1e-5)")
    return losses, times, staging, launches


# --- main ---------------------------------------------------------------------

REPLACES = {
    "fwd_lse": ("fa_fwd_kernel<T,D,true>",
                "byteps_tpu/ops/flash_attention.py:253"),
    "fwd": ("fa_fwd_kernel<T,D,false>",
            "byteps_tpu/ops/flash_attention.py:277"),
    "bwd_dq": ("fa_bwd_dq_kernel<T,D>",
               "byteps_tpu/ops/flash_attention.py:463"),
    "bwd_dkv": ("fa_bwd_dkv_kernel<T,D>",
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
    errors, timing = kernel_phase()
    coll_losses, coll_times, coll_launches, profile = collective_phase()
    ps_losses, ps_times, ps_staging, ps_launches = ps_phase(coll_losses)

    warm = slice(1, None)  # the first step pays one-time set-up
    summary = {
        "build_s": build_s,
        "collective": {"losses": coll_losses, "step_ms": coll_times,
                       "median_step_ms": sorted(coll_times[warm])[
                           len(coll_times[warm]) // 2],
                       "launches": coll_launches, "profile": profile},
        "ps": {"losses": ps_losses, "step_ms": ps_times,
               "staging_ms": [{k: v * 1e3 for k, v in s.items()}
                              for s in ps_staging],
               "launches": ps_launches},
        "sdpa_fwd_bwd_ms": timing["sdpa_fwd_bwd_ms"],
        "kernel_errors": errors,
        "kernel_readings": timing["readings"],
    }
    print(json.dumps(summary))
    kernels = []
    for name, (fn, replaces) in REPLACES.items():
        kernels.append({
            "name": f"flash_attention.{name} ({fn})", "route": "cuda",
            "source": "byteps_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces, "launches": coll_launches[name],
            "max_abs_err": errors[name]["gpt2"], **timing[name]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
