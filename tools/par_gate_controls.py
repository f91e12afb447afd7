#!/usr/bin/env python3
"""How far phase 10's gates sit from a faulty parallel path, on the card.

    python3 tools/par_gate_controls.py

``chip_smoke.py``'s phase 10 holds (a) TP, (b) the pipelines, (c) ZeRO
and (d) EP to one-process runs. This script reads what those gates read,
for the sound paths and for planted faults, on two processes sharing
cuda:0 in a gloo group (as phase 10 runs them), at the seed-0 weights
and tokens, through phase 10's own functions:

- ``psum_identity_backward``, (a) and (b): ``psum``'s backward returns
  its gradient unsummed (Megatron's identity, not JAX's transpose);
- ``tp_row_shards_swapped``, (a): each rank takes the other rank's rows
  of ``out`` and ``mlp_out`` (its heads and MLP columns its own);
- ``1f1b_ring_of_n_slots``, (b): 1F1B's ring of stored stage inputs has
  N slots, not 2N, so the first stage recomputes some microbatches from
  a later one's input;
- ``zero_sum_not_mean``, (c): the reduce-scattered gradient is not
  divided by the group's size (AdamW is nearly blind to the scale);
- ``zero_gather_reversed``, (c): the all-gather puts the shards in
  reverse rank order;
- ``moe_a2a_misrouted``, (d): the dispatch all-to-all's received blocks
  come in reverse rank order, so each rank's expert outputs go home to
  the other rank.

Prints one JSON line (also written to chiprun_out/par_gate_controls.json)
with each reading, its gate, and the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import inspect
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

# each variant: the paths it runs ("sound" runs all four)
VARIANTS = {"sound": "abcd", "psum_identity_backward": "ab",
            "tp_row_shards_swapped": "a", "1f1b_ring_of_n_slots": "b",
            "zero_sum_not_mean": "c", "zero_gather_reversed": "c",
            "moe_a2a_misrouted": "d"}


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _fault(name, rank):
    """The context in which ``name``'s fault is planted."""
    import torch

    import byteps_tpu_torch.parallel as par
    from byteps_tpu_torch.parallel import _collectives as C
    from byteps_tpu_torch.parallel import moe, pipeline, zero

    if name == "sound":
        return contextlib.nullcontext()
    if name == "psum_identity_backward":
        return _patched(C._PSum, "backward",
                        staticmethod(lambda ctx, g: (g, None)))
    if name == "tp_row_shards_swapped":
        def other_rows(w, group):
            return w.chunk(C.group_size(group), dim=0)[1 - rank]
        return _patched(par, "shard_rows", other_rows)
    if name == "1f1b_ring_of_n_slots":
        src = inspect.getsource(pipeline.pipeline_1f1b)
        assert "slots = 2 * n" in src
        ns = {}
        exec(compile(src.replace("slots = 2 * n", "slots = n"),
                     pipeline.__file__, "exec"), pipeline.__dict__, ns)
        return _patched(par, "pipeline_1f1b", ns["pipeline_1f1b"])
    if name == "zero_sum_not_mean":
        return _patched(zero, "zero_apply",
                        functools.partial(zero.zero_apply, average=False))
    if name == "zero_gather_reversed":
        gather = zero.all_gather

        def reversed_gather(out, inp, group):
            gather(out, inp, group)
            out.copy_(torch.cat(out.chunk(C.group_size(group))[::-1]))
        return _patched(zero, "all_gather", reversed_gather)
    if name == "moe_a2a_misrouted":
        a2a = moe.all_to_all

        def misrouted(x, group, split_dim, concat_dim):
            out = a2a(x, group, split_dim, concat_dim)
            if split_dim == 0:  # the dispatch: blocks by source rank
                out = torch.cat(out.chunk(C.group_size(group),
                                          dim=concat_dim)[::-1],
                                dim=concat_dim)
            return out
        return _patched(moe, "all_to_all", misrouted)
    raise ValueError(name)


def worker(out_dir, rank, port):
    import torch
    import torch.distributed as dist

    from byteps_tpu_torch.parallel import Mesh

    torch.cuda.set_device(0)
    os.environ["BYTEPS_PS_MODE"] = "collective"
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=cs.SP_RANKS,
        timeout=datetime.timedelta(seconds=cs.PAR_TIMEOUT_S))
    runs = {"a": lambda g, d: cs._par_tp(g, rank, d),
            "b": lambda g, d: cs._par_pp(g, rank, d),
            "c": lambda g, d: cs._par_zero(g, rank),
            "d": lambda g, d: cs._par_moe(g, rank, d)}
    rec = {}
    try:
        pair = Mesh((cs.SP_RANKS,), ("pair",)).group("pair")
        for variant, paths in VARIANTS.items():
            sub = os.path.join(out_dir, variant)
            os.makedirs(sub, exist_ok=True)
            rec[variant] = {}
            for key in paths:
                with _fault(variant, rank):
                    rec[variant][key] = runs[key](pair, sub)
                cs.log(f"controls {rank}: {variant} ({key}) done")
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def _readings(ref, recs, sub, paths):
    """What phase 10's gates read (``chip_smoke._par_gates``), worst over
    the ranks."""
    import torch

    def rel(got, want):
        return abs(got - want) / abs(want)
    out = {}
    if "a" in paths:
        got, want = cs._tp_gathered(ref, sub)
        out["a"] = {
            "loss_rel": max(rel(x, ref["tp_loss"]) for r in recs
                            for x in r["a"]["losses"] + [r["a"]["eval_loss"]]),
            "grad_rel_l2": cs._rel_l2(got, want)}
    if "b" in paths:
        pp = [torch.load(os.path.join(sub, f"pp{r}.pt"))
              for r in range(cs.SP_RANKS)]
        out["b"] = {f"{name}_{what}": value for name in ("1f1b", "gpipe")
                    for what, value in (
                        ("loss_rel", max(rel(r["b"][name]["loss"],
                                             ref["pp_loss"]) for r in recs)),
                        ("grad_rel_l2", cs._rel_l2(
                            [g for r in pp for g in r[name]],
                            ref["pp_grads"])))}
        out["b"]["1f1b_vs_gpipe_rel_l2"] = max(
            r["b"]["rel_l2_1f1b_gpipe"] for r in recs)
    if "c" in paths:
        out["c"] = {
            "loss_rel": max(rel(z, d) for r in recs
                            for z, d in zip(r["c"]["zero"]["losses"],
                                            r["c"]["dense"]["losses"])),
            "param_err_over_tolerance": max(
                r["c"]["param_err_over_tolerance"] for r in recs)}
    if "d" in paths:
        moe = [torch.load(os.path.join(sub, f"moe{r}.pt"))
               for r in range(cs.SP_RANKS)]
        out["d"] = {}
        for k in (1, 2):
            dense = ref[f"moe{k}"]
            out["d"][f"top{k}"] = {
                "out_rel_l2": max(cs._rel_l2([moe[r][k]["y"]],
                                             [dense["y"][r]])
                                  for r in range(cs.SP_RANKS)),
                "dropped": [r["d"][f"top{k}"]["dropped"] for r in recs],
                "dense_dropped": dense["dropped"],
                "grad_rel_l2": cs._rel_l2(
                    [sum(m[k]["grads"][i] for m in moe) for i in range(3)],
                    dense["grads"])}
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("par_gate_controls: needs a GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.build_all()
    ref = cs._par_references()
    tmp = tempfile.mkdtemp(prefix="par_gate_controls_")
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    port = cs._free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", tmp,
         str(rank), str(port)], env=env, cwd=HERE)
        for rank in range(cs.SP_RANKS)]
    try:
        rcs = [p.wait(timeout=3 * cs.PAR_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    if rcs != [0] * cs.SP_RANKS:
        print(f"par_gate_controls: workers exited {rcs}", file=sys.stderr)
        return 1
    recs = []
    for rank in range(cs.SP_RANKS):
        with open(os.path.join(tmp, f"rank{rank}.json")) as f:
            recs.append(json.load(f))
    out = {"device": smi,
           "gates": {"a": {"loss_rel": cs.TP_LOSS_REL,
                           "grad_rel_l2": cs.RING_GRAD_REL_L2},
                     "b": {"loss_rel": 1e-5,
                           "grad_rel_l2": cs.PP_GRAD_REL_L2},
                     "c": {"loss_rel": 1e-5, "param_err_over_tolerance": 1},
                     "d": {"out_rel_l2": cs.MOE_OUT_REL,
                           "dropped": "equal to dense_dropped",
                           "grad_rel_l2": cs.MOE_GRAD_REL_L2}},
           "readings": {
               variant: _readings(ref, [{k: r[variant][k] for k in paths}
                                        for r in recs],
                                  os.path.join(tmp, variant), paths)
               for variant, paths in VARIANTS.items()}}
    line = json.dumps(out)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "par_gate_controls.json"),
              "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
        sys.exit(0)
    sys.exit(main())
