"""ZeRO-style sharded optimizer state over the data-parallel groups.

Counterpart of ``byteps_tpu/parallel/zero.py``: the parameters are
flattened into ONE f32 buffer, the gradients reduce-scattered so that each
process owns 1/n of them (the first half of an all-reduce's traffic), the
optimizer updates ONLY the owned shard, with state allocated for that
shard alone (optimizer state divided by the group's size), and the
updated shards are all-gathered and copied back into the parameters in
place.

Elementwise optimizers (SGD, momentum, Adam, AdamW) act per element, so
for f32 parameters the sharded update equals the unsharded one, element
for element. Lower-precision parameters take their f32 values into the
shard each step and are cast back after the all-gather. Optimizers that
couple elements across parameters (global-norm clipping) need that
coupling computed over the whole model first.

A torch optimizer is bound to its tensors, so where the JAX version takes
an optax transformation this takes a factory,
``optimizer(params: list[Tensor]) -> torch.optim.Optimizer``, and the
sharded state is the optimizer it builds over this process's f32 shard.
Per-process code over ``group``; a group of ``None`` has one member.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

import byteps_tpu_torch as bps
from byteps_tpu_torch.parallel import hierarchical as _h
from byteps_tpu_torch.parallel._collectives import (Group, all_gather,
                                                    group_rank, group_size,
                                                    pmean, reduce_scatter)
from byteps_tpu_torch.parallel.mesh import Mesh, global_mesh

OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


def _flatten(tensors: Sequence[torch.Tensor], n: int) -> torch.Tensor:
    """Every tensor as f32, concatenated, zero-padded to a multiple of
    ``n``."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    pad = (-flat.numel()) % n
    return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat


def _unflatten_into(flat: torch.Tensor,
                    tensors: Sequence[torch.Tensor]) -> None:
    """Copy ``flat``'s leading elements back into ``tensors``, each in
    its own shape and dtype."""
    off = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[off:off + t.numel()].reshape(t.shape))
            off += t.numel()


def zero_init(model_or_params, optimizer: OptimizerFactory,
              group: Group = None) -> torch.optim.Optimizer:
    """Per-process: this process's optimizer over its f32 shard of the
    flattened, padded parameters (``zero_apply`` refreshes the shard's
    values from the parameters each step)."""
    n, i = group_size(group), group_rank(group)
    flat = _flatten(_h.tree_flatten(model_or_params)[0], n)
    size = flat.numel() // n
    return optimizer([flat[i * size:(i + 1) * size].clone()])


def zero_apply(model_or_params, grads: Sequence[torch.Tensor],
               opt_shard: torch.optim.Optimizer, *, group: Group = None,
               average: bool = True) -> None:
    """Per-process: one sharded optimizer update, in place.

    ``grads`` are this process's own gradients, in the parameters' order
    (before any reduction): their fused buffer is reduce-scattered over
    ``group`` (divided by n with ``average``), the shard's optimizer
    steps, and the shards are all-gathered into the parameters."""
    params = _h.tree_flatten(model_or_params)[0]
    n, i = group_size(group), group_rank(group)
    g_shard = _flatten(grads, n)
    size = g_shard.numel() // n
    if n > 1:
        flat_g, g_shard = g_shard, g_shard.new_empty(size)
        reduce_scatter(g_shard, flat_g, group)
        del flat_g  # before the parameters' flat copy is made
        if average:
            g_shard = g_shard / n
    flat_p = _flatten(params, n)
    shard = opt_shard.param_groups[0]["params"][0]
    with torch.no_grad():
        shard.copy_(flat_p[i * size:(i + 1) * size])
    shard.grad = g_shard
    opt_shard.step()
    shard.grad = None
    if n > 1:
        all_gather(flat_p, shard.detach().contiguous(), group)
    else:
        flat_p = shard.detach()
    _unflatten_into(flat_p, params)


def _groups(mesh: Optional[Mesh], axis: Optional[str]):
    """(shard group, the other data-parallel groups): the mesh's dcn and
    ici axes, or without a mesh the groups ``init`` holds; the shard
    axis is ``axis``, else the innermost."""
    st = bps._st()
    cfg = st.config
    if mesh is None and axis is None:
        return st.group, [st.dcn_group]
    mesh = mesh or global_mesh()
    names = [a for a in (cfg.dcn_axis, cfg.ici_axis) if a in mesh.axis_names]
    if not names:
        raise ValueError(
            f"mesh axes {mesh.axis_names} do not include the configured "
            f"dcn/ici axes ({cfg.dcn_axis!r}, {cfg.ici_axis!r}); build the "
            "mesh with byteps_tpu_torch.parallel.build_mesh or init with "
            "matching axis names")
    shard = axis or names[-1]
    return mesh.group(shard), [mesh.group(a) for a in names if a != shard]


def zero_init_sharded(model_or_params, optimizer: OptimizerFactory,
                      mesh: Optional[Mesh] = None, *,
                      axis: Optional[str] = None) -> torch.optim.Optimizer:
    """This process's sharded optimizer for ``make_zero_train_step``,
    over the shard axis (``axis``, else the innermost data-parallel
    one)."""
    return zero_init(model_or_params, optimizer, _groups(mesh, axis)[0])


def make_zero_train_step(loss_fn: Callable,
                         opt_shard: torch.optim.Optimizer,
                         mesh: Optional[Mesh] = None, *,
                         axis: Optional[str] = None):
    """Build ``step(model_or_params, batch) -> loss``, the contract of
    ``training.make_train_step`` with the optimizer state sharded:
    ``opt_shard`` comes from ``zero_init_sharded`` over the same
    parameters, mesh and axis.

    The gradients are averaged over the data-parallel groups other than
    the shard axis first (a plain mean), then over the shard axis by
    ``zero_apply``'s reduce-scatter. The returned loss is detached and
    averaged over every group. Collective mode only."""
    if bps._st().config.use_ps:
        raise NotImplementedError(
            "make_zero_train_step covers collective mode only; in PS mode "
            "the cross-host reduction rides the servers, which this step "
            "does not drive; use make_train_step, or shard by hand with "
            "zero_apply inside your own step")
    shard_group, others = _groups(mesh, axis)

    def step(model_or_params, batch) -> torch.Tensor:
        params = _h.tree_flatten(model_or_params)[0]
        for p in params:
            p.grad = None
        loss = loss_fn(model_or_params, batch)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        loss = loss.detach()
        for g in others:
            grads = _h.tree_all_reduce(grads, ici_group=g, average=True)
            loss = pmean(loss, g)
        zero_apply(params, grads, opt_shard, group=shard_group)
        for p in params:
            p.grad = None
        return pmean(loss, shard_group)

    return step
