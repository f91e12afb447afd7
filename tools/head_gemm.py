#!/usr/bin/env python3
"""GPT-2 small's cuBLAS products on the card, each kernel named by the
product it ran, and the tied head's three products timed at the
vocabulary as it is and padded to a multiple of 64 rows.

    python3 tools/head_gemm.py [--tree DIR] [--time-head] [--out FILE]

1. ``kernels``: one forward and backward of GPT2Small (flash attention,
   bf16, seed-0 weights, 12 x 1024 tokens, ``lm_loss``) after a warm-up
   step, with ``byteps_tpu_torch`` imported from ``--tree`` (this
   checkout by default, or e.g. the parent commit unpacked under
   ``dist/``), under ``torch.profiler`` and a dispatch mode that wraps
   each ``mm``, ``addmm``, ``bmm`` and ``baddbmm`` in a profiler range
   named by the product: (M, N, K) of ``A [M, K] @ B [K, N]``, each
   operand's leading dimension (its larger stride; a stride of 1 in the
   last dimension is row-major, ``T`` marks a transposed view) and
   whether its data sits on a 16-byte boundary. Each kernel the
   profiler attributes to a range is listed under it with its device
   time; products of one signature are merged, with their count. The
   profiler loses device records on this card, so a product may list
   fewer kernels than it ran.
2. ``head`` (with ``--time-head``): the head's products at GPT-2
   small's shape, each on tensors of its own: the forward ``x @ E^T``,
   the input's gradient ``dY @ E`` and the table's ``dY^T @ x`` (x
   [12288, 768], E [V, 768], dY [12288, V], bf16), at V = 50257 and at
   V = 50304, timed by CUDA-graph replays in turns
   (``chip_smoke._time_alternating``: median, least and most of 5
   windows of 20 calls), with the TFLOP/s of the 50257 real columns.

Prints one JSON line: the card's name and power limit, the tree, and
the tables.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENS, D, V = 12 * 1024, 768, 50257


def _operand(t) -> str:
    """``ld<n>`` (``T`` for a transposed view) and ``a16`` when the data
    sits on a 16-byte boundary."""
    s0, s1 = t.stride()[-2:]
    ld, trans = (s0, "") if s1 == 1 else (s1, "T")
    aligned = t.data_ptr() % 16 == 0
    return f"ld{ld}{trans}{' a16' if aligned else ''}"


def _signature(name: str, args) -> str:
    """The product's label: op, batch, (M, N, K), and each operand's
    leading dimension and alignment."""
    a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") else args[:2]
    batch = f"b{a.shape[0]} " if a.dim() == 3 else ""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    return (f"{name} {batch}M{m} N{n} K{k} A {_operand(a)} "
            f"B {_operand(b)} {a.dtype}".replace("torch.", ""))


def kernels_by_product(torch, make_step) -> list:
    """[{product, count, kernels: [[name, ms a step]]}] of one step
    ``make_step()`` under the profiler, the products in the order they
    first ran."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = {torch.ops.aten.mm.default: "mm",
           torch.ops.aten.addmm.default: "addmm",
           torch.ops.aten.bmm.default: "bmm",
           torch.ops.aten.baddbmm.default: "baddbmm"}

    class Named(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = ops.get(func)
            if name is None:
                return func(*args, **(kwargs or {}))
            with record_function("gemm| " + _signature(name, args)):
                return func(*args, **(kwargs or {}))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with Named():
            make_step()
        torch.cuda.synchronize()
    rows, order = {}, []
    cpu = torch.autograd.DeviceType.CPU
    for ev in prof.events():
        # a range is listed on the host and again as the card's annotation
        if ev.name.startswith("gemm| ") and ev.device_type == cpu:
            key = ev.name[len("gemm| "):]
            if key not in rows:
                rows[key] = {"product": key, "count": 0, "kernels": {}}
                order.append(key)
            rows[key]["count"] += 1
    for ev in prof.events():
        if not ev.kernels:
            continue
        up = ev
        while up is not None and not up.name.startswith("gemm| "):
            up = up.cpu_parent
        if up is None:
            continue
        ks = rows[up.name[len("gemm| "):]]["kernels"]
        for k in ev.kernels:
            ks[k.name] = ks.get(k.name, 0.0) + k.duration / 1e3
    out = []
    for key in order:
        r = rows[key]
        r["kernels"] = sorted(([n, ms] for n, ms in r["kernels"].items()),
                              key=lambda kv: -kv[1])
        out.append(r)
    return out


def head_products(torch, time_alternating) -> list:
    """The head's three products at V and padded to a multiple of 64,
    timed in turns: [{product, rows, ms, min_ms, max_ms, tflops}]."""
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda",
                           dtype=torch.bfloat16)

    fns, real = {}, 2 * TOKENS * D * V
    for rows in (V, V + (-V % 64)):
        x, e, dy = rand(TOKENS, D), rand(rows, D), rand(TOKENS, rows)
        fns[f"forward x @ E^T|{rows}"] = lambda x=x, e=e: x @ e.T
        fns[f"input grad dY @ E|{rows}"] = lambda dy=dy, e=e: dy @ e
        fns[f"table grad dY^T @ x|{rows}"] = lambda dy=dy, x=x: dy.T @ x
    times = time_alternating(fns)
    out = []
    for key, (med, lo, hi) in times.items():
        product, rows = key.split("|")
        out.append({"product": product, "rows": int(rows), "ms": med,
                    "min_ms": lo, "max_ms": hi,
                    "tflops": real / (med / 1e3) / 1e12})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", default=HERE)
    p.add_argument("--time-head", action="store_true")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    sys.path.insert(1, HERE)
    import torch

    from byteps_tpu_torch.models import GPT2Small, lm_loss

    if not torch.cuda.is_available():
        print("head_gemm: needs a CUDA device", file=sys.stderr)
        return 2
    model = GPT2Small(vocab_size=V, dtype=torch.bfloat16, attn_impl="flash",
                      generator=torch.Generator().manual_seed(0))
    tokens = torch.randint(0, V, (12, 1024),
                           generator=torch.Generator().manual_seed(1)
                           ).cuda()

    def step():
        model.zero_grad(set_to_none=True)
        lm_loss(model(tokens), tokens).backward()

    step()
    out = {"kernels": kernels_by_product(torch, step)}
    del model
    torch.cuda.empty_cache()
    if args.time_head:
        from chip_smoke import _time_alternating
        out["head"] = head_products(torch, _time_alternating)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    line = json.dumps({"card": smi, "tree": os.path.abspath(args.tree),
                       **out})
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
