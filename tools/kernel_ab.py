#!/usr/bin/env python3
"""The flash kernels of two trees, checked and timed in turns on the card.

    python3 tools/kernel_ab.py OTHER_TREE --cases gpt2_f32,unaligned_f32 \\
        --order other,this,this,other --out OUT

OTHER_TREE is a second checkout (e.g. ``git archive`` of the parent
unpacked into ``dist/``, which is git-ignored and copied to the card's
machine). Both trees' ``csrc/flash_attention.cu`` are built first, in
parallel, each into its own ``build/``. Then each side in ``--order``
runs in a process of its own: this tree's ``chip_smoke.kernel_phase`` on
the named cases (``chip_smoke.CASES``), with ``byteps_tpu_torch`` imported
from that side's tree, so both sides are held to the same plain versions,
limits and timing. Each run's result goes to OUT/<n>_<side>.json; then
each kernel's device ms (median of 5 windows, in turns with SDPA), bound,
SDPA ms and max abs error are printed per run, after the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import threading

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke(tree):
    """This tree's chip_smoke, importing byteps_tpu_torch from ``tree``."""
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _build(tree):
    subprocess.run([sys.executable, "-c",
                    "from byteps_tpu_torch.ops import _cuda_lib; "
                    "_cuda_lib.build('flash_attention')"],
                   cwd=tree, check=True)


def _run(tree, cases, out):
    smoke = _smoke(tree)
    import byteps_tpu_torch
    assert os.path.dirname(os.path.dirname(
        os.path.abspath(byteps_tpu_torch.__file__))) == tree
    errors, report = smoke.kernel_phase(cases=cases)
    with open(out, "w") as f:
        json.dump({"tree": tree, "errors": errors, "report": report}, f)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("other", nargs="?")
    p.add_argument("--cases", required=True)
    p.add_argument("--order", default="other,this,this,other")
    p.add_argument("--out")
    p.add_argument("--run", metavar="TREE")
    p.add_argument("--result", metavar="FILE")
    args = p.parse_args()
    cases = tuple(args.cases.split(","))
    if args.run:
        return _run(os.path.abspath(args.run), cases, args.result)
    if not args.out:
        p.error("--out is required")
    trees = {"this": HERE}
    if args.other:
        trees["other"] = os.path.abspath(args.other)
    os.makedirs(args.out, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    builds = [threading.Thread(target=_build, args=(t,))
              for t in trees.values()]
    for t in builds:
        t.start()
    for t in builds:
        t.join()
    rc = 0
    for i, side in enumerate(args.order.split(","), 1):
        res = os.path.join(args.out, f"{i}_{side}.json")
        with open(os.path.join(args.out, f"{i}_{side}.err"), "w") as err:
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--run", trees[side], "--cases", args.cases,
                                "--result", res], stderr=err)
        print(f"run {i} {side} rc={r.returncode}", flush=True)
        rc = rc or r.returncode
        if r.returncode:
            continue
        with open(res) as f:
            d = json.load(f)
        for case, timed in d["report"].items():
            if case == "readings":
                continue
            for kname in ("fwd_lse", "fwd", "bwd_dq", "bwd_dkv"):
                t = timed[kname]
                print(f"  {case} {kname}: ms {t['ms']:.4f} "
                      f"{[round(x, 4) for x in t['ms_spread']]} bound "
                      f"{t['bound_ms']:.4f} ({t['bound_by']}) sdpa "
                      f"{t['library_ms']:.4f} ({t['library_backend']}) "
                      f"plain {t['plain_ms']:.3f} err "
                      f"{d['errors'][kname][case]:.3e}")
        for case, det in d["report"]["readings"].items():
            print(f"  {case} err/limit: " + json.dumps(
                {k: round(v["err_over_limit"], 3) for k, v in det.items()}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
