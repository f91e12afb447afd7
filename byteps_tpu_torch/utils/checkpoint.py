"""Checkpoint / resume (``torch.save``-backed).

Counterpart of ``byteps_tpu/utils/checkpoint.py``, with the same API and
on-disk layout: ``save_checkpoint`` (rank 0 writes
``base_dir/step_<n>`` and prunes to ``keep``), ``latest_step``, and
``restore_checkpoint`` (every rank loads, then ``broadcast_parameters``
re-syncs the fleet from rank 0, the reference's resume pattern).

``state`` is a tree of dicts (``state_dict()``s included), lists, tuples
and namedtuples over tensors, numbers, strings and None. It is stored as
one flat ``{path: leaf}`` dict (``state.pt``; a path is the tuple of
keys, indices and field names from the root), which ``torch.load`` reads
with ``weights_only=True``. A write goes to a temporary directory that
replaces ``step_<n>`` in one rename, so a reader never sees half a
checkpoint.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

_STEP_RE = re.compile(r"^step_(\d+)$")
_FILE = "state.pt"


def _ckpt_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step}")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) pairs of ``tree`` in its own order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if not isinstance(k, (str, int)):
                raise TypeError(f"checkpoint keys must be str or int, got "
                                f"{k!r} at {path}")
            yield from _flatten(v, path + (k,))
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from _flatten(getattr(tree, f), path + (f,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (i,))
    else:
        yield path, tree


def _to_host(leaf):
    if not torch.is_tensor(leaf):
        return leaf
    t = leaf.detach().cpu()
    # torch.save writes a tensor's whole storage: copy views out
    if (not t.is_contiguous()
            or t.untyped_storage().nbytes() != t.numel() * t.element_size()):
        t = t.clone()
    return t


def save_checkpoint(base_dir: str, state: Any, step: int,
                    *, keep: int = 3, rank: Optional[int] = None) -> str:
    """Write ``state`` under ``base_dir/step_<step>`` and prune old steps.

    Only rank 0 writes: ``rank`` defaults to ``bps.rank()`` once
    byteps_tpu_torch is initialised, else 0; other ranks return the path
    at once, the reference's rank-0-saves convention.
    """
    if rank is None:
        import byteps_tpu_torch as bps
        rank = bps.rank() if bps.initialized() else 0
    path = _ckpt_dir(base_dir, step)
    if rank != 0:
        return path
    leaves = {p: _to_host(v) for p, v in _flatten(state)}
    os.makedirs(base_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".step_{step}.", dir=base_dir)
    try:
        with open(os.path.join(tmp, _FILE), "wb") as f:
            torch.save(leaves, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(path):  # a re-save of the same step
            old = tempfile.mkdtemp(prefix=f".old_step_{step}.", dir=base_dir)
            os.replace(path, os.path.join(old, "step"))
            os.replace(tmp, path)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _prune(base_dir, keep)
    return path


def latest_step(base_dir: str) -> Optional[int]:
    """Largest step with a saved checkpoint, or None."""
    if not os.path.isdir(base_dir):
        return None
    steps = [int(m.group(1)) for name in os.listdir(base_dir)
             if (m := _STEP_RE.match(name))]
    return max(steps) if steps else None


def restore_checkpoint(base_dir: str, target: Any,
                       step: Optional[int] = None, *,
                       broadcast: bool = True) -> tuple:
    """Restore ``(state, step)`` into ``target``'s structure, by path, not
    by flatten order: each tensor takes the target leaf's dtype, shape and
    device, each number its type. Entries that the checkpoint holds under
    a dict of the target but the target lacks (a fresh optimizer's empty
    ``state``) come back as nested dicts of CPU tensors, which
    ``Optimizer.load_state_dict`` places beside their parameters. With
    ``broadcast`` (and byteps_tpu_torch initialised) every tensor is then
    overwritten with rank 0's through ``broadcast_parameters``.

    Returns ``(target, None)`` unchanged when no checkpoint exists.
    """
    if step is None:
        step = latest_step(base_dir)
        if step is None:
            return target, None
    saved = torch.load(os.path.join(_ckpt_dir(base_dir, step), _FILE),
                       map_location="cpu", weights_only=True)
    state = _restore(target, (), saved)
    if broadcast:
        import byteps_tpu_torch as bps
        if bps.initialized():
            tensors = [v for _, v in _flatten(state) if torch.is_tensor(v)]
            if tensors:
                bps.broadcast_parameters(tensors, root_rank=0,
                                         name="checkpoint")
    return state, step


def _restore(target, path: Tuple, saved: Dict[Tuple, Any]):
    if torch.is_tensor(target):
        v = torch.as_tensor(_saved(saved, path))
        return v.to(target.dtype).reshape(target.shape).to(target.device)
    if isinstance(target, dict):
        out = {k: _restore(v, path + (k,), saved) for k, v in target.items()}
        for k in _children(saved, path):
            if k not in out:
                out[k] = _rebuild(saved, path + (k,))
        return type(target)(out)
    if _is_namedtuple(target):
        return type(target)(*[_restore(getattr(target, f), path + (f,),
                                       saved) for f in target._fields])
    if isinstance(target, (list, tuple)):
        return type(target)(_restore(v, path + (i,), saved)
                            for i, v in enumerate(target))
    v = _saved(saved, path)
    if isinstance(target, (bool, int, float)) and v is not None:
        return type(target)(v)
    return v


def _saved(saved, path):
    try:
        return saved[path]
    except KeyError:
        raise KeyError(f"the checkpoint holds no entry at {path}") from None


def _children(saved, path):
    """The keys one level below ``path`` in the checkpoint, in order."""
    n = len(path)
    return list(dict.fromkeys(p[n] for p in saved
                              if len(p) > n and p[:n] == path))


def _rebuild(saved, path):
    if path in saved:
        return saved[path]
    return {k: _rebuild(saved, path + (k,)) for k in _children(saved, path)}


def _prune(base_dir: str, keep: int) -> None:
    steps = sorted(int(m.group(1)) for name in os.listdir(base_dir)
                   if (m := _STEP_RE.match(name)))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_ckpt_dir(base_dir, s), ignore_errors=True)
