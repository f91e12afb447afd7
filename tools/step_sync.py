#!/usr/bin/env python3
"""Where a training step waits for the card, on one GPU.

    python3 tools/step_sync.py [--out step_sync.json]
        [--paths gpt2_bf16,gpt2_f32,resnet50,bert_large,llama1b]

For each path (chip_smoke.py's steps: GPT-2 small in bf16, phase 3's,
and in f32, phase 13's, 8 x 512 tokens; BERT-Large MLM, phase 6's;
Llama-1B 4 x 2048, phase 7's; each AdamW through ``make_train_step``,
flash attention; phase 5 (a)'s ResNet-50 step: 224^2, batch 256, bf16,
SGD 0.1 / 0.9 through ``make_stateful_train_step``, cuDNN deterministic),
after two warm-up steps:

- ``chip_smoke._profile_step``: the step under the sync debug mode with
  the caching allocator's counters, the card's time behind a sleep with
  the marker check of whether the card ever waited for the host
  (``_card_backlog``), and the step's launches;
- one step enqueued behind a ~0.5 s ``torch.cuda._sleep``, every aten op
  logged with its host clock (a ``TorchDispatchMode``): the op, or the gap
  between two ops (a kernel launched through ctypes), where the host sat
  for most of the sleep is where it waited, and how many ops it had
  enqueued by then;
- a planted wait, the control of the marker check: two steps with an
  ``.item()`` of the first's loss between them, which the check must
  read as the card waiting.

Then the depth of the card's launch queue: behind the sleep, how many
launches of a small elementwise kernel, and of the flash forward at a
small shape (three 128-byte tensor maps among its parameters), the host
enqueues before a launch blocks.

Prints (and writes to ``--out``) one JSON object with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

SLEEP_CYCLES = 1_000_000_000  # ~0.5 s at the H100's clocks
BLOCKED_MS = 50.0             # a host call this long waited for the card


def _paths():
    """{name: build() -> run() -> loss} of the steps named above."""
    import torch

    import chip_smoke as cs

    def lm(spec, **make_kw):
        def build():
            from byteps_tpu_torch.training import make_train_step
            model = spec.make(**make_kw)
            opt = torch.optim.AdamW(model.parameters(), lr=1e-4,
                                    weight_decay=1e-4)
            step = make_train_step(spec.loss, opt)
            batch = spec.batch(next(model.parameters()).device)
            return lambda: step(model, batch)
        return build

    def resnet():
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        model = cs._resnet()
        batch = cs._images(cs.IMAGE_BATCH, next(model.parameters()).device)
        step = cs._resnet_step("collective", model)
        return lambda: step(batch)

    return {"gpt2_bf16": lm(cs.GPT2),
            "gpt2_f32": lm(cs.GPT2, dtype=torch.float32),
            "resnet50": resnet, "bert_large": lm(cs.BERT),
            "llama1b": lm(cs.LLAMA)}


def _behind_sleep(run):
    """One ``run()`` enqueued behind the sleep, every aten op logged:
    where the host waited."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = []

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            t0 = time.perf_counter()
            out = func(*args, **(kwargs or {}))
            ops.append((str(func), t0, time.perf_counter()))
            return out

    before, start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(3))
    torch.cuda.synchronize()
    before.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    with Log():
        run()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    waits = []
    prev_end, prev_name = t0, "(start)"
    for i, (name, a, b) in enumerate(ops):
        if (a - prev_end) * 1e3 > BLOCKED_MS:
            waits.append({"between": [prev_name, name], "op_index": i,
                          "ms": (a - prev_end) * 1e3})
        if (b - a) * 1e3 > BLOCKED_MS:
            waits.append({"in": name, "op_index": i, "ms": (b - a) * 1e3})
        prev_end, prev_name = b, name
    return {"enqueue_behind_sleep_ms": enqueue_ms,
            "sleep_ms": before.elapsed_time(start),
            "device_ms": start.elapsed_time(end), "aten_ops": len(ops),
            "waits": waits}


def _launches_cpu_activity(run):
    """``chip_smoke._launch_counts`` of a step profiled with CPU activity
    too (``_profile_step`` profiles CUDA activity alone)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return cs._launch_counts(prof)


def _queue_depth(launch, n=4096):
    """Launches enqueued behind the sleep before one blocks."""
    import torch
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    blocked_at = None
    for i in range(n):
        t0 = time.perf_counter()
        launch()
        if (time.perf_counter() - t0) * 1e3 > BLOCKED_MS:
            blocked_at = i
            break
    torch.cuda.synchronize()
    return blocked_at


def main() -> int:
    import torch
    p = argparse.ArgumentParser()
    p.add_argument("--out")
    p.add_argument("--paths",
                   default="gpt2_bf16,gpt2_f32,resnet50,bert_large,llama1b")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import byteps_tpu_torch as bps
    import chip_smoke as cs
    cs.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"card": card.strip(), "paths": {}}
    os.environ["BYTEPS_PS_MODE"] = "collective"
    bps.init()
    try:
        for name, build in _paths().items():
            if name not in args.paths.split(","):
                continue
            torch.cuda.reset_peak_memory_stats()
            run = build()
            for _ in range(2):
                run()
            torch.cuda.synchronize()
            try:
                profile = cs._profile_step(run)
                profile.pop("top_kernels_ms")
            # a synchronizing call or an allocator retry in the step
            except (RuntimeError, AssertionError) as e:
                profile = {"step_error": str(e)[:500]}
            rec = {"profile": profile,
                   "behind_sleep_ops": _behind_sleep(run),
                   "planted_wait": cs._card_backlog(
                       lambda: [run().item(), run()]),
                   "launches_cpu_activity": _launches_cpu_activity(run),
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            out["paths"][name] = rec
            cs.log(name, json.dumps(rec))
            del run
            torch.cuda.empty_cache()
    finally:
        bps.shutdown()
    fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")
    x = torch.zeros(1024, device="cuda")
    q = torch.randn(1, 64, 1, 64, device="cuda", dtype=torch.bfloat16)
    out["launch_queue_depth"] = {
        "add_": _queue_depth(lambda: x.add_(1)),
        "flash_fwd": _queue_depth(lambda: fa.flash_fwd(q, q, q, True, 0.125,
                                                       return_lse=False)),
    }
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
