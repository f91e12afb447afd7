"""The comparison that decides ``correct``.

The program's first steps (``Program.first_steps``: each step's loss, the
first gradient as the optimizer got it, the parameters' change over the
steps) are held against the plain reference's, run on the same seed's
weights and batches in f32 with TF32 off once the program is gone. Three
numbers, each against its limit in ``portbench/limits/<cell>.json``:

- ``loss_gap``: the largest |program - reference| / |reference| of a
  step's loss;
- ``grad_gap``: over the leaves, the largest gap between the program's
  and the reference's norm of the first gradient, over the reference's
  norm of that leaf or of the median leaf, whichever is larger (the
  median of the leaves the first step gives a gradient: a ResNet block's
  branch gets none while its last norm's scale is 0);
- ``change_gap``: the same of the parameters' change, over the leaves
  the reference moves by its gradient: a leaf whose reference gradient
  stays under a thousandth of the median leaf's in every checked step
  (a key's bias under softmax) moves under Adam by round-off alone, and
  is left out by that rule;
- ``wire_short`` (PS cells): the largest share of the f32 gradient's
  bytes that a checked step did not move through the worker's PS van,
  over the steps and the two directions, push and pull. With one worker
  the pull brings back what was pushed, so the three numbers above read
  the same whether or not the round trip ran; this one reads 0 when each
  step moved at least the whole gradient each way (the van's counts
  include each frame's header), and 1 when it moved nothing.
"""

from __future__ import annotations

import math
import statistics

import torch

from portbench.reference import exact_f32, make_weights

QUIET = 1e-3
NUMBERS = ("loss_gap", "grad_gap", "change_gap")
WIRE = "wire_short"


def reference_steps(cell, seed: int, device, n: int = 3,
                    fp8: bool = False) -> dict:
    """The reference's first ``n`` steps on the seed's weights and
    batches: as ``Program.first_steps`` returns them. ``fp8`` rounds the
    operands of every product to fp8: the control."""
    from portbench.program import modules
    ref, inputs, optim, _ = modules(cell)
    hp = cell.traffic["optimizer"]
    with exact_f32():
        params = {k: v.clone().requires_grad_()
                  for k, v in make_weights(ref.specs(cell.cfg), seed,
                                           device).items()}
        start = {k: v.detach().clone() for k, v in params.items()}
        batches = inputs.pool(cell.cfg, cell.traffic, seed, device)[:n]
        state, losses, norms = {}, [], []
        for t, batch in enumerate(batches, 1):
            loss = ref.loss(params, batch, cell.cfg, fp8=fp8)
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
            losses.append(float(loss.detach()))
            norms.append({k: float(g.norm()) for k, g in grads.items()})
            optim.step(params, grads, state, hp, t)
            del loss, grads
        change = {k: float((params[k].detach() - start[k]).norm())
                  for k in params}
    return {"losses": losses, "grad_norms": norms[0],
            "change_norms": change, "step_grad_norms": norms,
            "grad_bytes": 4 * sum(p.numel() for p in params.values())}


def _median_leaf(norms) -> float:
    return statistics.median([x for x in norms if x > 0] or [1.0])


def _worst(got: dict, want: dict, leaves) -> float:
    floor = _median_leaf(want[k] for k in leaves)
    return max(abs(got[k] - want[k]) / max(want[k], floor) for k in leaves)


def numbers(got: dict, want: dict) -> dict:
    """The three numbers of ``got`` (the program's first steps) against
    ``want`` (the reference's)."""
    if set(got["grad_norms"]) != set(want["grad_norms"]):
        raise ValueError("the program's and the reference's leaves differ")
    leaves = sorted(want["grad_norms"])
    steps = want["step_grad_norms"]
    floor = _median_leaf(want["grad_norms"].values())
    moved = [k for k in leaves
             if max(s[k] for s in steps) >= QUIET * floor]
    out = {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(got["losses"], want["losses"])),
        "grad_gap": _worst(got["grad_norms"], want["grad_norms"], leaves),
        "change_gap": _worst(got["change_norms"], want["change_norms"],
                             moved),
    }
    if "wire" in got:
        out[WIRE] = max(max(0.0, 1.0 - n / want["grad_bytes"])
                        for step in got["wire"] for n in step)
    return out


def verdict(readings: dict, limits: dict):
    """(correct, {number: [reading, limit]}) over the numbers ``limits``
    names: correct when every one was read, is finite and is at most its
    limit."""
    pairs = {k: [readings.get(k), lim] for k, lim in limits.items()}
    ok = all(x is not None and math.isfinite(x) and x <= lim
             for x, lim in pairs.values())
    return ok, pairs
