"""Collectives over ``torch.distributed`` groups that autograd carries.

``all_to_all``, ``ppermute`` and ``psum`` are the counterparts of
``lax.all_to_all(..., tiled=True)``, ``lax.ppermute`` and ``lax.psum``:
each is a ``torch.autograd.Function`` whose backward is the transposed
collective (the inverse all-to-all, the permutation run the other way
round, and for ``psum`` a ``psum`` of the gradients), which is the
gradient ``jax.grad`` takes through them under ``shard_map`` with
``check_vma=False``. So a loss that every member computes whole after a
``psum`` is divided by the group's size, and the gradients of parameters
the members hold alike are summed over the group afterwards, as the JAX
package's tests do. ``pmean`` is ``psum`` over the size.
``torch.distributed`` ops carry no autograd of their own. ``all_to_all``
and ``ppermute`` both go through ``all_to_all_single``: a ring
permutation is an all-to-all whose splits send everything to one rank
and receive everything from one rank.

NCCL carries them on the card and gloo on the CPU. Two processes that
share one card run them in a gloo group, which NCCL cannot form. That
group's collectives of CUDA tensors copy through host memory here,
explicitly: gloo takes CUDA tensors itself, but its reduce-scatter then
allocates another copy of the whole input on the card (3.86 GiB for
Llama-1B's gradient), room that two ranks sharing one card do not have
to spare. The group's backend decides it
(``stages``), and ``BYTES["staged"]`` counts the bytes copied each way.
An NCCL group never stages. The flat collectives below are the ones
``hierarchical``, the models and the training step use. Every function
is per-process code: each member of ``group`` calls it with its own
tensors, and a group of ``None`` has one member.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]

# Bytes this process sent into all-to-alls, ring permutations and
# differentiable psums (their inputs, the share it keeps included), and
# bytes staged through host memory (device to host plus host to device).
BYTES = {"all_to_all": 0, "ppermute": 0, "psum": 0, "staged": 0}

# Newer releases rename the flat-tensor collectives (*_single) and
# deprecate the old names; the two take the same arguments.
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def reset_bytes() -> None:
    for name in BYTES:
        BYTES[name] = 0


def group_size(group: Group) -> int:
    """Members of ``group``; a level of ``None`` has one."""
    return dist.get_world_size(group) if group is not None else 1


def group_rank(group: Group) -> int:
    """This process's index in ``group`` (0 for a level of ``None``)."""
    return dist.get_rank(group) if group is not None else 0


def stages(group: Group, t: torch.Tensor) -> bool:
    """Whether a collective of ``group`` on ``t`` copies through host
    memory: a gloo group with a CUDA tensor."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _run(group: Group, outs: Sequence[torch.Tensor],
         ins: Sequence[torch.Tensor],
         op: Callable[[List[torch.Tensor], List[torch.Tensor]], None]):
    """``op(outs, ins)``, on host copies when the group stages; the
    results are written into ``outs``."""
    if not stages(group, ins[0]):
        op(list(outs), list(ins))
        return
    host_in = [t.cpu() for t in ins]
    host_out = []
    for o in outs:  # an in-place op's output is its input's copy
        same = [h for t, h in zip(ins, host_in) if t is o]
        host_out.append(same[0] if same else
                        torch.empty(o.shape, dtype=o.dtype))
    op(host_out, host_in)
    for o, h in zip(outs, host_out):
        o.copy_(h)
    BYTES["staged"] += (sum(t.numel() * t.element_size() for t in ins)
                        + sum(t.numel() * t.element_size() for t in outs))


def all_to_all_single(out: torch.Tensor, inp: torch.Tensor, group: Group,
                      out_splits: Optional[List[int]] = None,
                      in_splits: Optional[List[int]] = None) -> None:
    """``dist.all_to_all_single`` on contiguous tensors: dim 0 of ``inp``
    split in ``in_splits`` (equal parts when None), part j to rank j; the
    part from rank i lands in ``out``'s i-th ``out_splits`` slice."""
    _run(group, [out], [inp], lambda o, i: dist.all_to_all_single(
        o[0], i[0], out_splits, in_splits, group=group))


def all_reduce_(t: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place."""
    _run(group, [t], [t], lambda o, i: dist.all_reduce(o[0], group=group))
    return t


def reduce_scatter(out: torch.Tensor, inp: torch.Tensor,
                   group: Group) -> None:
    """``out`` = this rank's 1/n slice (dim 0) of the sum of ``inp``."""
    _run(group, [out], [inp],
         lambda o, i: _reduce_scatter(o[0], i[0], group=group))


def all_gather(out: torch.Tensor, inp: torch.Tensor, group: Group) -> None:
    """``out`` = every rank's ``inp`` concatenated on dim 0, in rank
    order."""
    _run(group, [out], [inp],
         lambda o, i: _all_gather(o[0], i[0], group=group))


def broadcast_(t: torch.Tensor, src: int, group: Group) -> torch.Tensor:
    """``t`` = the tensor of global rank ``src``, in place."""
    _run(group, [t], [t],
         lambda o, i: dist.broadcast(o[0], src=src, group=group))
    return t


# --- differentiable collectives ----------------------------------------------

def _a2a(x: torch.Tensor, group: Group, split_dim: int,
         concat_dim: int) -> torch.Tensor:
    n = group_size(group)
    moved = x.movedim(split_dim, 0)
    inp = moved.reshape(n, moved.shape[0] // n, *moved.shape[1:])
    inp = inp.contiguous()
    out = torch.empty_like(inp)
    BYTES["all_to_all"] += inp.numel() * inp.element_size()
    all_to_all_single(out, inp, group)
    # out[i] is rank i's part for this rank: its chunk of the split dim
    return torch.cat([p.movedim(0, split_dim) for p in out.unbind(0)],
                     dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return _a2a(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return _a2a(g, group, concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, group: Group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
    ``x`` split into n chunks on ``split_dim``, chunk j sent to rank j,
    and the chunks received from ranks 0..n-1 concatenated on
    ``concat_dim`` in that order. ``split_dim``'s size must divide by n."""
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of shape "
                         f"{tuple(x.shape)} does not divide by {n}")
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def _shift(x: torch.Tensor, group: Group, shift: int) -> torch.Tensor:
    n, me = group_size(group), group_rank(group)
    flat = x.contiguous().reshape(-1)
    send, recv = [0] * n, [0] * n
    send[(me + shift) % n] = recv[(me - shift) % n] = flat.numel()
    out = torch.empty_like(flat)
    BYTES["ppermute"] += flat.numel() * flat.element_size()
    all_to_all_single(out, flat, group, recv, send)
    return out.reshape(x.shape)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.args = (group, shift)
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        group, shift = ctx.args
        return _shift(g, group, -shift), None, None


def ppermute(x: torch.Tensor, group: Group, shift: int) -> torch.Tensor:
    """``lax.ppermute(x, axis, [(i, (i + shift) % n) for i in range(n)])``:
    each rank sends ``x`` to rank ``(me + shift) % n`` and returns what
    rank ``(me - shift) % n`` sent."""
    n = group_size(group)
    if shift % n == 0:
        return x
    return _PPermute.apply(x, group, shift)


def _sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    out = x.contiguous().clone()
    BYTES["psum"] += out.numel() * out.element_size()
    return all_reduce_(out, group)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def psum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``lax.psum(x, axis)``: the sum of every member's ``x``, on every
    member. Its backward is a ``psum`` of the gradients."""
    if group_size(group) == 1:
        return x
    return _PSum.apply(x, group)


def pmean(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``lax.pmean(x, axis)``: ``psum`` over the group's size."""
    n = group_size(group)
    return x if n == 1 else psum(x, group) / n
