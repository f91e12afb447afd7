#!/usr/bin/env python3
"""Host cost of the overlapped PS steps' gradient hooks, on the card.

    python3 tools/overlap_cost.py [--rounds N]

GPT-2 small (flash attention, bf16 compute, 8 x 512 tokens, AdamW) in one
process, with a loopback client in place of the C core: one worker, so a
push_pull's sum is the array itself and a wait returns at once. No fleet
and no network: what is timed is the host and the card. Each variant has
its own model from the seed-0 weights; the variants run in turns, one
step each per round, for N rounds after one warm-up round:

- ``plain``: zero_grad, forward, backward, optimizer step; no hooks;
- ``noop_hooks``: the same with a post-accumulate hook on each of the 196
  parameters that returns at once;
- ``overlap_f32`` / ``overlap_bf16``: ``make_overlapped_train_step``;
- ``bucketed_multi``: ``make_bucketed_overlap_step`` with hook-driven
  buckets.

For each: the step's host time (ending in a synchronize), the host time
from the step's start to backward() returning, and, for the overlap
variants, the host time spent inside the hooks and inside the stager's
jobs (copy, wait, push; summed over the step; wall time, so waits for the
interpreter lock and, in the stager, for the D2H copy are in it). Then
the host cost of each piece of the hook alone (``piece_us``: us per
call, one thread).
Prints one JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import byteps_tpu_torch as bps  # noqa: E402
from byteps_tpu_torch.bucketed import make_bucketed_overlap_step  # noqa: E402
from byteps_tpu_torch.core import ffi  # noqa: E402
from byteps_tpu_torch.models import GPT2Small, lm_loss  # noqa: E402
from byteps_tpu_torch.overlap import (_TapState,  # noqa: E402
                                      make_overlapped_train_step)


class Loopback:
    """The C client for one worker with no server: the sum is the array."""

    def declare(self, name, nelem, dtype, compression=None):
        return 0

    def push_pull(self, tid, arr, average=True, async_mode=False,
                  dtype=None):
        return 0

    def wait(self, handle):
        pass

    def poll(self, handle):
        return True

    def shutdown(self):
        pass


def _loss(model, tokens):
    return lm_loss(model(tokens), tokens)


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def _plain_step(opt):
    def step(model, tokens):
        opt.zero_grad(set_to_none=True)
        step.timings = {"start": time.perf_counter()}
        _loss(model, tokens).backward()
        step.timings["backward"] = time.perf_counter()
        opt.step()
    return step


def _enter_exit(ctx) -> None:
    with ctx:
        pass


def piece_costs(n: int = 2000) -> dict:
    """Host us per call of each piece of the overlap hook, one thread, no
    other thread wanting the interpreter lock: what a hook costs when
    nothing contends."""
    import queue

    from byteps_tpu_torch import ps
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.randn(768, 768, device=dev)
    host = ps.host_buffer(g.numel(), g.dtype, True)
    copy_stream = torch.cuda.Stream(dev)
    ev = torch.cuda.Event()
    q = queue.Queue()
    pieces = {
        "detach_reshape": lambda: g.detach().reshape(-1),
        "cast_bf16": lambda: g.to(torch.bfloat16),
        "current_stream": lambda: torch.cuda.current_stream(dev),
        "new_event": lambda: torch.cuda.Event(),
        "event_record": lambda: ev.record(copy_stream),
        "ready_event": lambda: ps.ready_event(g),
        "wait_event": lambda: copy_stream.wait_event(ev),
        "stream_context": lambda: _enter_exit(torch.cuda.stream(copy_stream)),
        "d2h_copy_2.4MB": lambda: host.copy_(g.reshape(-1),
                                             non_blocking=True),
        "record_stream": lambda: g.record_stream(copy_stream),
        "copy_to_host": lambda: ps.copy_to_host([(g, host)], [ev],
                                                copy_stream),
        "queue_put_get": lambda: (q.put(1), q.get()),
    }
    out = {}
    for name, fn in pieces.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("overlap_cost: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    # host time inside the hooks and the stager's jobs, per step
    spent = {"hook": 0.0, "stager": 0.0}

    def timed(fn, key):
        def wrapper(*a):
            t0 = time.perf_counter()
            try:
                return fn(*a)
            finally:
                spent[key] += time.perf_counter() - t0
        return wrapper
    _TapState._on_grad = timed(_TapState._on_grad, "hook")
    _TapState._drain = timed(_TapState._drain, "stager")

    os.environ["BYTEPS_PS_MODE"] = "ps"
    ffi.Worker.start = classmethod(lambda cls, cfg: Loopback())
    bps.init()
    rng = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, 50257, (8, 512), generator=rng).cuda()
    variants = {}
    for name in ("plain", "noop_hooks", "overlap_f32", "overlap_bf16",
                 "bucketed_multi"):
        model = GPT2Small(attn_impl="flash",
                          generator=torch.Generator().manual_seed(0))
        opt = torch.optim.AdamW(model.parameters(), lr=1e-4,
                                weight_decay=1e-4)
        if name.startswith("overlap"):
            step = make_overlapped_train_step(
                _loss, opt, prefix=name,
                wire_dtype="bfloat16" if name == "overlap_bf16"
                else "float32")
        elif name == "bucketed_multi":
            step = make_bucketed_overlap_step(_loss, opt, prefix=name,
                                              multi_program=True)
        else:
            if name == "noop_hooks":
                for p in model.parameters():
                    p.register_post_accumulate_grad_hook(lambda p: None)
            step = _plain_step(opt)
        variants[name] = (model, step)
    readings = {name: {"step_ms": [], "backward_ms": [], "hook_ms": [],
                       "stager_ms": []} for name in variants}
    for r in range(args.rounds + 1):
        for name, (model, step) in variants.items():
            spent.update(hook=0.0, stager=0.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(model, tokens)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if r == 0:
                continue  # warm-up round
            t = step.timings
            rd = readings[name]
            rd["step_ms"].append((t1 - t0) * 1e3)
            rd["backward_ms"].append((t["backward"] - t["start"]) * 1e3)
            rd["hook_ms"].append(spent["hook"] * 1e3)
            rd["stager_ms"].append(spent["stager"] * 1e3)
    bps.shutdown()
    out = {"device": smi, "rounds": args.rounds,
           "piece_us": piece_costs(), "variants": {
        name: {k: {"median": _median(v), "min": min(v), "max": max(v)}
               for k, v in rd.items()}
        for name, rd in readings.items()}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
