#!/usr/bin/env python3
"""How far phase 9's model-level gates sit from a faulty SP path, on the card.

    python3 tools/sp_gate_controls.py

``chip_smoke.py``'s phase 9 holds (b)'s step-1 loss to the unsharded
run's at rtol 1e-5 and (c)'s ring gradients to Ulysses + flash's within
``RING_GRAD_REL_L2``. This script reads what those gates read, for the
sound path and for planted faults, on two processes sharing cuda:0 in a
gloo group (as phase 9 runs them), at the seed-0 weights and tokens:

- (b)'s step-1 loss (Llama-1B, flash, 8192 tokens over the pair, one
  forward): sound; with each rank's RoPE positions local (0..4095 on
  both) instead of global; with each block's last position left
  unscored (plain ``lm_loss`` per block, the boundary token dropped);
- (c)'s gradient distance (depth ``SP_RING_LAYERS``, ring against
  Ulysses + flash): sound; with the all-to-all's backward returning the
  blocks of the two ranks swapped.

Prints one JSON line (also written to chiprun_out/sp_gate_controls.json)
with each reading, its gate, and the card's name and power limit.
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402


def _loss_controls(sp, rank):
    import torch

    from byteps_tpu_torch.models import lm_loss, sp_lm_loss
    from byteps_tpu_torch.parallel import _collectives as C

    local = cs.SP_SEQ // cs.SP_RANKS
    tokens = cs._long_tokens("cuda")[:, rank * local:(rank + 1) * local]
    model = cs._llama_long("flash", sp_group=sp)
    def mean(loss):  # over the pair, as make_train_step reports it
        return (C.all_reduce_(loss.reshape(1), sp) / cs.SP_RANKS).item()
    out = {}
    with torch.no_grad():
        logits = model(tokens)
        out["sound"] = mean(sp_lm_loss(logits, tokens, sp))
        # every block scored without its last position
        out["boundary_dropped"] = mean(lm_loss(logits, tokens))
        del logits
        positions = torch.arange(local, device="cuda")[None]
        out["local_positions"] = mean(sp_lm_loss(model(tokens, positions),
                                                 tokens, sp))
    del model
    cs._free()
    return out


def _swapped_backward(ctx, g):
    """The all-to-all's backward with the ranks' blocks in reverse order:
    each rank's gradient lands on the other rank."""
    import torch

    from byteps_tpu_torch.parallel import _collectives as C

    group, split_dim, concat_dim = ctx.args
    back = C._a2a(g, group, concat_dim, split_dim)
    blocks = back.chunk(C.group_size(group), dim=split_dim)
    return torch.cat(blocks[::-1], dim=split_dim), None, None, None


def worker(out_dir, rank, port):
    import torch
    import torch.distributed as dist

    from byteps_tpu_torch.parallel import Mesh
    from byteps_tpu_torch.parallel import _collectives as C

    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=cs.SP_RANKS,
        timeout=datetime.timedelta(seconds=cs.SP_TIMEOUT_S))
    try:
        sp = Mesh((cs.SP_RANKS,), ("sp",)).group("sp")
        rec = {"loss": _loss_controls(sp, rank),
               "grad_rel_l2": {"sound": cs._sp_ring_check(sp, rank)
                               ["grad_rel_l2"]}}
        sound_backward = C._AllToAll.backward
        C._AllToAll.backward = staticmethod(_swapped_backward)
        try:
            rec["grad_rel_l2"]["a2a_backward_swapped"] = cs._sp_ring_check(
                sp, rank)["grad_rel_l2"]
        finally:
            C._AllToAll.backward = sound_backward
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def main():
    import torch
    if not torch.cuda.is_available():
        print("sp_gate_controls: needs a GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.build_all()
    tmp = tempfile.mkdtemp(prefix="sp_gate_controls_")
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    port = cs._free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", tmp,
         str(rank), str(port)], env=env, cwd=HERE)
        for rank in range(cs.SP_RANKS)]
    try:
        rcs = [p.wait(timeout=cs.SP_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    if rcs != [0] * cs.SP_RANKS:
        print(f"sp_gate_controls: workers exited {rcs}", file=sys.stderr)
        return 1
    ranks = []
    for rank in range(cs.SP_RANKS):
        with open(os.path.join(tmp, f"rank{rank}.json")) as f:
            ranks.append(json.load(f))
    sound = ranks[0]["loss"]["sound"]
    out = {"device": smi,
           "step1_loss_rel_diff": {
               k: abs(v - sound) / abs(sound)
               for k, v in ranks[0]["loss"].items() if k != "sound"},
           "step1_loss_gate": 1e-5,
           "grad_rel_l2_gate": cs.RING_GRAD_REL_L2, "ranks": ranks}
    line = json.dumps(out)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "sp_gate_controls.json"),
              "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
        sys.exit(0)
    sys.exit(main())
