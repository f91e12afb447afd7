"""Pipeline parallelism: GPipe and 1F1B microbatch schedules over a group.

Counterpart of ``byteps_tpu/parallel/pipeline.py``. Each process of
``group`` (the JAX version's ``pp`` axis) owns ONE stage's parameters and
runs every microbatch through it in turn; stage-to-stage transfer is a
ring ``ppermute`` (``_collectives.ppermute``, whose backward runs the
ring the other way). With M microbatches and N stages ``gpipe`` runs
M + N - 1 ticks, the GPipe bubble (N-1)/(M+N-1), and is differentiated
by autograd; ``pipeline_1f1b`` runs M + 2N - 2 ticks and computes the
gradients itself with O(N) stored activations.

Every process must issue its collectives in the same order. In JAX the
tick loop is one static SPMD program; here each process builds its own
autograd graph, and the backward issues each ``ppermute``'s transpose in
the order that graph dictates. So ``gpipe`` builds the same graph on
every process: each tick runs ``stage_fn`` and picks between the feed
and the carry, and between a result and zeros, with ``torch.where`` on
the process's index, never with a Python branch. ``pipeline_1f1b``
builds no graph across ticks; it skips the stage on idle ticks but runs
both of a tick's ``ppermute``s on every process.

Per-process code over ``group``; a group of ``None`` has one member.
"""

from __future__ import annotations

from typing import Callable

import torch

from byteps_tpu_torch.parallel import hierarchical as _h
from byteps_tpu_torch.parallel._collectives import (Group, group_rank,
                                                    group_size, ppermute,
                                                    psum)


def _flag(value: bool, device) -> torch.Tensor:
    return torch.tensor(value, device=device)


def gpipe(stage_fn: Callable, params_local, microbatches: torch.Tensor, *,
          group: Group = None) -> torch.Tensor:
    """Run ``microbatches`` through the N-stage pipeline.

    - ``stage_fn(params_local, x) -> y``: this process's stage; the
      activations ``x`` and ``y`` have one shape across stages;
    - ``params_local``: this process's stage parameters (a module, or a
      tree from ``stage_params``);
    - ``microbatches``: [M, ...], the same on every process; M >= 1.

    Returns [M, ...], the last stage's outputs, on every process (the
    ring's wrap-around brings each finished microbatch to process 0,
    which collects them; a ``psum`` of the masked buffer replicates
    them). Differentiable: a loss every process computes from the output
    is divided by N, as under ``psum``.
    """
    n, idx = group_size(group), group_rank(group)
    m = microbatches.shape[0]
    dev = microbatches.device
    first = _flag(idx == 0, dev)
    carry = torch.zeros_like(microbatches[0])
    outputs = [torch.zeros_like(microbatches[0]) for _ in range(m)]
    for t in range(m + n - 1):
        # stage 0 takes microbatch t (while there is one), the others what
        # the ring delivered last tick
        x = torch.where(first, microbatches[min(t, m - 1)], carry)
        y = stage_fn(params_local, x)
        mb = t - idx  # the microbatch at this process this tick
        y = torch.where(_flag(0 <= mb < m, dev), y, torch.zeros_like(y))
        carry = ppermute(y, group, 1)
        # process 0 received the last stage's output of microbatch t-(n-1)
        done = t - (n - 1)
        slot = min(max(done, 0), m - 1)
        take = _flag(idx == 0 and 0 <= done < m, dev)
        outputs[slot] = torch.where(take, carry, outputs[slot])
    out = torch.stack(outputs)
    return psum(torch.where(first, out, torch.zeros_like(out)), group)


def pipeline_1f1b(stage_fn: Callable, loss_fn: Callable, params_local,
                  microbatches: torch.Tensor, targets: torch.Tensor, *,
                  group: Group = None):
    """One-forward-one-backward (1F1B) pipeline training.

    ``gpipe`` keeps every microbatch's activations until the backward:
    O(M) memory a process. Here fwd(m) runs on process d at tick m + d
    (GPipe's timing) with no graph, bwd(m) at tick m + 2(N-1) - d, which
    recomputes the stage from its stored INPUT under autograd and takes
    its vector-Jacobian product; a stored input lives at most 2(N-1-d)
    ticks, so the store is a fixed ring of 2N slots: O(N) activation
    memory, whatever M. Both ring transfers (activations +1, gradients
    -1, the latter in f32) run every tick on every process.

    - ``stage_fn(params_local, x) -> y``, as in ``gpipe``;
    - ``loss_fn(y, target) -> scalar``, on the LAST stage's output of a
      microbatch; the mean over microbatches is returned;
    - ``microbatches``, ``targets``: [M, ...], the same on every process.

    Returns ``(loss, grads)``: the mean loss on every process and THIS
    process's stage-parameter gradients of it, in f32, in the structure
    of ``params_local`` (a module's as a list in ``parameters()`` order).
    No backward() around this is needed.
    """
    n, idx = group_size(group), group_rank(group)
    m = microbatches.shape[0]
    params, unflatten = _h.tree_flatten(params_local)
    slots = 2 * n  # at most 2(N-1)+1 stored inputs are live
    fwd_carry = torch.zeros_like(microbatches[0])
    bwd_carry = torch.zeros_like(microbatches[0], dtype=torch.float32)
    resid = [None] * slots
    grads = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    loss_acc = torch.zeros((), device=microbatches.device)
    for t in range(m + 2 * n - 2):
        # forward half: GPipe's timing, no graph
        mb_f = t - idx
        y = torch.zeros_like(fwd_carry)
        if 0 <= mb_f < m:
            x = microbatches[mb_f] if idx == 0 else fwd_carry
            resid[mb_f % slots] = x
            with torch.no_grad():
                y = stage_fn(params_local, x)
        fwd_next = ppermute(y, group, 1)

        # backward half: bwd(m) on process d at tick m + 2(N-1) - d
        mb_b = t - 2 * (n - 1) + idx
        dx = torch.zeros_like(bwd_carry)
        if 0 <= mb_b < m:
            x_saved = resid[mb_b % slots].detach().requires_grad_()
            with torch.enable_grad():
                y_b = stage_fn(params_local, x_saved)
                if idx == n - 1:
                    # the last stage seeds the chain from the microbatch's
                    # loss; the others take what the -1 ring delivered
                    y_leaf = y_b.detach().requires_grad_()
                    loss_m = loss_fn(y_leaf, targets[mb_b]) / m
                    seed, = torch.autograd.grad(loss_m, y_leaf)
                    loss_acc = loss_acc + loss_m.detach().float()
                else:
                    seed = bwd_carry.to(y_b.dtype)
                *dp, dx = torch.autograd.grad(y_b, params + [x_saved], seed,
                                              allow_unused=True)
            for a, d in zip(grads, dp):
                if d is not None:
                    a.add_(d.float())
            dx = dx.float()
        bwd_carry = ppermute(dx, group, -1)
        fwd_carry = fwd_next
    # each microbatch's loss was divided by m; the psum brings the last
    # stage's mean to every process (the others hold zero)
    return psum(loss_acc, group), unflatten(grads)


def stage_params(stacked, group: Group = None):
    """This process's stage slice of a tree (tensor, list, tuple or dict)
    whose tensors are stacked [num_stages, ...]."""
    leaves, unflatten = _h.tree_flatten(stacked)
    i = group_rank(group)
    return unflatten([w[i] for w in leaves])
