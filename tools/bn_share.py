#!/usr/bin/env python3
"""ResNet-50's card time for a training step, split by CUDA events around
its batch norms.

    python3 tools/bn_share.py [--tree DIR] [--steps N] [--out FILE]

Trains ResNet-50 (bf16, seed-0 weights, 256 images of 224 x 224 from
``chip_smoke._images``, SGD 0.1 / 0.9, cross-entropy) with
``byteps_tpu_torch`` imported from ``--tree`` (this checkout by default,
or e.g. the parent commit unpacked under ``dist/``). After 3 warm-up
steps, each of N steps is enqueued behind a sleep of the card
(``chip_smoke._card_backlog``), so the card runs it without waiting for
the host, with a timing event before and after each ``BatchNorm``
module's forward (forward hooks) and backward (full backward hooks). A
norm's time is the card's time between its two events; the rest of the
step is everything else (convolutions, pooling, the residual adds and
their ReLU, the loss, the update). Where ``BatchNorm`` leaves the ReLU
after it to the block (the torch-op norm), that ReLU counts in the rest.

Prints one JSON line: the card's name and power limit, and per step the
card's ms, the norms' forward and backward ms, their share, whether the
card never waited for the host (``device_ms_exact``), and the medians.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", default=HERE)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    sys.path.insert(1, HERE)
    import torch

    import chip_smoke
    from byteps_tpu_torch.models import ResNet50
    from byteps_tpu_torch.models.resnet import BatchNorm
    from byteps_tpu_torch.stateful import cross_entropy_loss

    if not torch.cuda.is_available():
        print("bn_share: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(0))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    x, y = chip_smoke._images(chip_smoke.IMAGE_BATCH, "cuda")
    x = x.contiguous(memory_format=torch.channels_last)
    events = []  # (norm index, "fwd" | "bwd", "start" | "end", event)
    armed = [False]

    def mark(i, way, end):
        if armed[0]:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((i, way, end, ev))

    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for i, m in enumerate(norms):
        m.register_forward_pre_hook(lambda mod, a, i=i: mark(i, "fwd", 0))
        m.register_forward_hook(lambda mod, a, o, i=i: mark(i, "fwd", 1))
        m.register_full_backward_pre_hook(
            lambda mod, g, i=i: mark(i, "bwd", 0))
        m.register_full_backward_hook(
            lambda mod, gi, go, i=i: mark(i, "bwd", 1))

    def step():
        model.train()
        opt.zero_grad()
        cross_entropy_loss(model(x), y).backward()
        opt.step()

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    steps = []
    for _ in range(args.steps):
        events.clear()
        armed[0] = True
        card = chip_smoke._card_backlog(step)
        armed[0] = False
        spans = {}
        for i, way, end, ev in events:
            spans.setdefault((i, way), [None, None])[end] = ev
        ms = {"fwd": 0.0, "bwd": 0.0}
        for (i, way), (a, b) in spans.items():
            ms[way] += a.elapsed_time(b)
        steps.append({"card_ms": card["device_ms"],
                      "device_ms_exact": card["device_ms_exact"],
                      "norms": len(norms), "norm_fwd_ms": ms["fwd"],
                      "norm_bwd_ms": ms["bwd"],
                      "norm_share": (ms["fwd"] + ms["bwd"])
                      / card["device_ms"]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"card": smi, "tree": os.path.abspath(args.tree), "steps": steps,
           "median": {k: statistics.median(s[k] for s in steps)
                      for k in ("card_ms", "norm_fwd_ms", "norm_bwd_ms",
                                "norm_share")}}
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
