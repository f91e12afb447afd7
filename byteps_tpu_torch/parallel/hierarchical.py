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
the card and gloo on the CPU; a gloo group on CUDA tensors (processes that
share a card) copies through host memory (``_collectives``). Every
function is per-process code: each member of the groups calls it with its
own tensors.

``quantized_all_reduce`` / ``tree_quantized_all_reduce`` are the int8
transport (``Compression.int8`` and ``int8_dcn``): each quantized level
reduce-scatters by an all-to-all of blockwise-int8 chunks and their f32
scales, summed in f32, and all-gathers int8 too.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from byteps_tpu_torch.parallel._collectives import (
    Group, all_gather, all_reduce_, all_to_all_single, broadcast_,
    group_size, reduce_scatter)

ReduceFn = Callable[[torch.Tensor], torch.Tensor]


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
        return all_reduce_(t.clone(), dcn)

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
    reduce_scatter(shard, flat.contiguous(), ici)
    if dcn is not None:
        shard = _slow(shard)
    if average and denom > 1:
        shard = shard / denom
    out = shard.new_empty(flat.numel())
    all_gather(out, shard.contiguous(), ici)
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
            broadcast_(y, dist.get_global_rank(group, src), group)
    return y


def tree_broadcast(tree, *, root: int = 0, ici_group: Group = None,
                   dcn_group: Group = None):
    """Broadcast a tensor, list, tuple or dict of tensors from ``root``."""
    leaves, unflatten = tree_flatten(tree)
    return unflatten([
        hierarchical_broadcast(x, root=root, ici_group=ici_group,
                               dcn_group=dcn_group)
        for x in leaves])


def _blockwise_quantize(x: torch.Tensor, block: int):
    """int8-quantize with one f32 scale per ``block`` values (x is padded
    to a block multiple by the caller). Returns (q[int8], scales[f32]).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    b = x.reshape(-1, block).to(torch.float32)
    scale = b.abs().amax(dim=1, keepdim=True) / 127.0
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(b / safe), -127, 127).to(torch.int8)
    return q, scale


def _blockwise_dequantize(q: torch.Tensor, scale: torch.Tensor
                          ) -> torch.Tensor:
    return (q.to(torch.float32) * scale).reshape(-1)


def _quantized_reduce_scatter(flat: torch.Tensor, group: Group,
                              block: int) -> torch.Tensor:
    """int8 reduce-scatter over ``group``: quantize per destination chunk,
    all-to-all the int8 chunks and their per-block f32 scales, sum the
    dequantized chunks locally in f32. ``flat``'s length must divide by
    (group size * block). Returns this process's 1/k shard of the sum."""
    k = group_size(group)
    chunk = flat.numel() // k
    q, scale = _blockwise_quantize(flat, block)
    q = q.reshape(k, chunk // block, block)
    scale = scale.reshape(k, chunk // block, 1)
    q_recv, s_recv = torch.empty_like(q), torch.empty_like(scale)
    all_to_all_single(q_recv, q, group)
    all_to_all_single(s_recv, scale, group)
    return (q_recv.to(torch.float32) * s_recv).sum(0).reshape(-1)


def _quantized_all_gather(shard: torch.Tensor, group: Group,
                          block: int) -> torch.Tensor:
    """int8 all-gather over ``group``: each process ships its quantized
    shard and scales; every process dequantizes the concatenation."""
    q, s = _blockwise_quantize(shard, block)
    k = group_size(group)
    q_all = q.new_empty((k * q.shape[0], block))
    s_all = s.new_empty((k * s.shape[0], 1))
    all_gather(q_all, q, group)
    all_gather(s_all, s, group)
    return _blockwise_dequantize(q_all, s_all)


def quantized_all_reduce(
    x: torch.Tensor,
    *,
    ici_group: Group = None,
    dcn_group: Group = None,
    average: bool = True,
    block: int = 256,
    quantize_dcn: bool = False,
) -> torch.Tensor:
    """Hierarchical all-reduce with int8 blockwise-quantized transport
    (EQuARX-style): a quarter of f32's bytes on each quantized level, at
    an error of at most half a quantization step (block max / 254) per
    value and stage.

    The ``ici`` level is quantized: its reduce-scatter is an all-to-all of
    int8 chunks and per-block f32 scales with a local f32 sum, and its
    all-gather ships int8. ``quantize_dcn=False`` keeps the ``dcn`` level
    exact (an f32 all-reduce of the shard); ``quantize_dcn=True`` runs the
    same int8 scheme over ``dcn`` too. Where only ``dcn`` has more than
    one member, ``quantize_dcn`` makes it the one quantized level. The
    sum is averaged (divided by the product of the levels' sizes) before
    the all-gather.
    """
    ici = ici_group if group_size(ici_group) > 1 else None
    dcn = dcn_group if group_size(dcn_group) > 1 else None
    denom = group_size(ici) * group_size(dcn)

    orig_shape, orig_dtype = x.shape, x.dtype
    flat = x.reshape(-1)
    n = flat.numel()

    if ici is None and dcn is None:
        return x
    if ici is None:
        # one process per host: dcn is the only level, quantized or not
        if quantize_dcn:
            ici, dcn = dcn, None
        else:
            flat = all_reduce_(flat.clone(), dcn)
            if average and denom > 1:
                flat = flat / denom
            return flat.reshape(orig_shape).to(orig_dtype)

    k = group_size(ici)
    kd = group_size(dcn)
    # pad so the ici shard also tiles (dcn size * block) when the dcn
    # level is quantized too
    pad = (-n) % (k * kd * block if (dcn is not None and quantize_dcn)
                  else k * block)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])

    # stage 1: int8 reduce-scatter over the fast level
    shard = _quantized_reduce_scatter(flat, ici, block)

    # stage 2: the slow level, exact or int8
    if dcn is not None:
        if quantize_dcn:
            dshard = _quantized_reduce_scatter(shard, dcn, block)
            if average:
                dshard = dshard / denom
            shard = _quantized_all_gather(dshard, dcn, block)
        else:
            all_reduce_(shard, dcn)
            if average:
                shard = shard / denom
    elif average and denom > 1:
        shard = shard / denom

    # stage 3: int8 all-gather back over the fast level
    out = _quantized_all_gather(shard, ici, block)
    if pad:
        out = out[:n]
    return out.reshape(orig_shape).to(orig_dtype)


def tree_quantized_all_reduce(
    tree,
    *,
    ici_group: Group = None,
    dcn_group: Group = None,
    average: bool = True,
    block: int = 256,
    quantize_dcn: bool = False,
):
    """Fused variant of ``quantized_all_reduce`` for a tensor, list, tuple
    or dict of tensors: one flat f32 buffer, one quantized collective
    pair; the identity when both levels have one member."""
    leaves, unflatten = tree_flatten(tree)
    if not leaves:
        return tree
    if group_size(ici_group) * group_size(dcn_group) == 1:
        return tree
    flat = torch.cat([leaf.reshape(-1).to(torch.float32)
                      for leaf in leaves])
    flat = quantized_all_reduce(flat, ici_group=ici_group,
                                dcn_group=dcn_group, average=average,
                                block=block, quantize_dcn=quantize_dcn)
    out, off = [], 0
    for leaf in leaves:
        sz = leaf.numel()
        out.append(flat[off:off + sz].reshape(leaf.shape).to(leaf.dtype))
        off += sz
    return unflatten(out)
