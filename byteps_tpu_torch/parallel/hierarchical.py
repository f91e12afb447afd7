"""Hierarchical two-level all-reduce over ``torch.distributed`` groups.

Counterpart of ``byteps_tpu/parallel/hierarchical.py``. One process drives
one GPU, and the JAX version's mesh axes become process groups:

    REDUCE      lax.psum_scatter over ``ici``  ->  reduce_scatter_tensor
                                                   over ``ici_group``
    PUSH/PULL   lax.psum over ``dcn``          ->  all_reduce over
                or the PS hook                     ``dcn_group``, or
                                                   ``dcn_reduce_fn``
    BROADCAST   lax.all_gather over ``ici``    ->  all_gather over
                                                   ``ici_group``

``tree_broadcast`` is a real broadcast at each level where the JAX version
takes a masked psum, so what the other processes held (NaN, an
uninitialised buffer) never reaches the result. A group of ``None`` is a level with one member. NCCL carries the groups on
the card and gloo on the CPU. Every function is per-process code: each
member of the groups calls it with its own tensors.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]
ReduceFn = Callable[[torch.Tensor], torch.Tensor]

# Newer releases rename the flat-tensor collectives (*_single) and
# deprecate the old names; the two take the same arguments.
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def group_size(group: Group) -> int:
    """Members of ``group``; a level of ``None`` has one."""
    return dist.get_world_size(group) if group is not None else 1


def hierarchical_all_reduce(
    x: torch.Tensor,
    *,
    ici_group: Group = None,
    dcn_group: Group = None,
    average: bool = True,
    dcn_reduce_fn: Optional[ReduceFn] = None,
) -> torch.Tensor:
    """Two-level all-reduce of one tensor.

    Stage 1 reduce-scatters over the fast ``ici_group`` so each process
    owns 1/ici_size of the tensor; stage 2 reduces those shards over the
    slow ``dcn_group`` (or hands them to ``dcn_reduce_fn``, the PS hook);
    stage 3 all-gathers the result back over ``ici_group``.
    """
    ici = ici_group if group_size(ici_group) > 1 else None
    dcn = dcn_group if group_size(dcn_group) > 1 else None
    denom = group_size(ici) * group_size(dcn)

    orig_shape, orig_dtype = x.shape, x.dtype
    flat = x.reshape(-1)
    n = flat.numel()

    def _slow(t):
        if dcn_reduce_fn is not None:
            return dcn_reduce_fn(t)
        t = t.clone()
        dist.all_reduce(t, group=dcn)
        return t

    if ici is None:
        # Single-process level: only the slow-level reduction applies.
        if dcn is not None:
            flat = _slow(flat)
        if average and denom > 1:
            flat = flat / denom
        return flat.reshape(orig_shape).to(orig_dtype)

    ici_size = group_size(ici)
    pad = (-n) % ici_size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])

    shard = flat.new_empty(flat.numel() // ici_size)
    _reduce_scatter(shard, flat.contiguous(), group=ici)
    if dcn is not None:
        shard = _slow(shard)
    if average and denom > 1:
        shard = shard / denom
    out = shard.new_empty(flat.numel())
    _all_gather(out, shard.contiguous(), group=ici)
    if pad:
        out = out[:n]
    return out.reshape(orig_shape).to(orig_dtype)


def tree_flatten(tree):
    """(leaves, unflatten) of a tensor, or of a list, tuple or dict of
    tensors (one level; dicts keep their insertion order)."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda ls: ls[0]
    if isinstance(tree, dict):
        keys = list(tree)
        return [tree[k] for k in keys], lambda ls: dict(zip(keys, ls))
    if isinstance(tree, (list, tuple)):
        kind = type(tree)
        return list(tree), lambda ls: kind(ls)
    raise TypeError(f"expected a tensor, list, tuple or dict of tensors, "
                    f"got {type(tree).__name__}")


def tree_all_reduce(
    tree,
    *,
    ici_group: Group = None,
    dcn_group: Group = None,
    average: bool = True,
    dcn_reduce_fn: Optional[ReduceFn] = None,
    fuse: bool = True,
):
    """All-reduce a tensor, list, tuple or dict of tensors.

    With ``fuse=True`` every leaf is flattened into one contiguous buffer
    in the widest participating dtype, so one reduce-scatter / all-gather
    pair carries the whole tree. When both levels have one member the
    all-reduce is the identity and the tree comes back as it went in.
    """
    leaves, unflatten = tree_flatten(tree)
    if not leaves:
        return tree
    if group_size(ici_group) * group_size(dcn_group) == 1:
        return tree
    kw = dict(ici_group=ici_group, dcn_group=dcn_group, average=average,
              dcn_reduce_fn=dcn_reduce_fn)
    if not fuse:
        return unflatten([hierarchical_all_reduce(g, **kw) for g in leaves])

    acc_dtype = leaves[0].dtype
    for leaf in leaves[1:]:
        acc_dtype = torch.promote_types(acc_dtype, leaf.dtype)
    flat = torch.cat([leaf.reshape(-1).to(acc_dtype) for leaf in leaves])
    flat = hierarchical_all_reduce(flat, **kw)
    out, off = [], 0
    for leaf in leaves:
        sz = leaf.numel()
        out.append(flat[off:off + sz].reshape(leaf.shape).to(leaf.dtype))
        off += sz
    return unflatten(out)


def hierarchical_broadcast(
    x: torch.Tensor,
    *,
    root: int = 0,
    ici_group: Group = None,
    dcn_group: Group = None,
) -> torch.Tensor:
    """Broadcast ``x`` from the process with linearised index ``root``
    (``ici_rank + dcn_rank * ici_size``): first over every ``ici_group``
    from its member at the root's ici index, then over every
    ``dcn_group`` from its member at the root's dcn index. Whatever the
    other processes held, NaN included, is overwritten."""
    ici = ici_group if group_size(ici_group) > 1 else None
    dcn = dcn_group if group_size(dcn_group) > 1 else None
    y = x.detach().clone().contiguous()
    ici_size = group_size(ici)
    for group, src in ((ici, root % ici_size), (dcn, root // ici_size)):
        if group is not None:
            dist.broadcast(y, src=dist.get_global_rank(group, src),
                           group=group)
    return y


def tree_broadcast(tree, *, root: int = 0, ici_group: Group = None,
                   dcn_group: Group = None):
    """Broadcast a tensor, list, tuple or dict of tensors from ``root``."""
    leaves, unflatten = tree_flatten(tree)
    return unflatten([
        hierarchical_broadcast(x, root=root, ici_group=ici_group,
                               dcn_group=dcn_group)
        for x in leaves])
