"""The data-parallel training steps.

Counterpart of ``make_train_step`` / ``_make_ps_train_step`` and
``make_async_train_step`` in ``byteps_tpu/jax/training.py``. The
synchronous step runs backward, reduces the gradients through
``push_pull``, and applies the optimizer:

- collective mode: the compression cast, the hierarchical all-reduce over
  the process groups (the local one, and a mesh's ``dcn`` group where
  ``init`` was given a mesh), the cast back; ``Compression.int8`` and
  ``int8_dcn`` replace the cast and the all-reduce with the quantized
  transport;
- PS mode: the local reduce, the compression cast, the host round trip
  through the CPU parameter servers (``ps_push_pull``), the cast back.
  With a local group of k > 1 processes the local level is a
  reduce-scatter: each rank's 1/k slice of every gradient goes through the
  host's shared staging and its root's client, and the group all-gathers
  the sums (``ps.local_push_pull``).

The asynchronous step (PS mode only) applies the optimizer locally and
pushes the parameters' change to servers that hold the parameters.

PyTorch runs eagerly, so there is nothing to jit or donate; the optimizer
updates the parameters in place. ``replicate`` and ``shard_batch`` have no
counterpart: broadcast the parameters with ``broadcast_parameters`` and
slice the global batch by ``rank()``.
"""

from __future__ import annotations

from typing import Callable

import torch

import byteps_tpu_torch as bps
from byteps_tpu_torch.compression import QUANTIZED, Compression, Compressor
from byteps_tpu_torch.parallel import hierarchical as _h


def make_train_step(
    loss_fn: Callable,
    optimizer: torch.optim.Optimizer,
    *,
    average: bool = True,
    compression: Compressor = Compression.none,
    ps_prefix: str = "grad",
):
    """Build ``step(model_or_params, batch) -> loss``.

    ``loss_fn(model_or_params, batch)`` returns a scalar tensor; the
    gradients of the parameters in ``optimizer.param_groups`` are reduced
    across workers (mean with ``average``, else sum) before
    ``optimizer.step()``. The returned loss is detached and, in collective
    mode, averaged over the process groups (in PS mode it is this
    process's). ``ps_prefix`` names the gradient tensors in the PS
    registry (PS mode only): the keys are those of the JAX package's PS
    step, whole leaves, with a local group too.
    """
    st = bps._st()
    use_ps = st.config.use_ps
    if use_ps and compression.name in QUANTIZED:
        raise ValueError(
            f"Compression {compression.name!r} (int8 quantized transport) "
            "only applies to collective mode. In PS mode use the C-core "
            "codec instead: declare tensors with a compressor config "
            "string (e.g. BYTEPS_COMPRESSOR=onebit or type=dithering;k=4), "
            "or use Compression.bf16/fp16 for a wire cast.")
    group = st.group
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def step(model_or_params, batch) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model_or_params, batch)
        loss.backward()
        live = [p for p in params if p.grad is not None]
        for p, g in zip(live, bps.push_pull(
                [p.grad for p in live], average=average, name=ps_prefix,
                compression=compression)):
            p.grad = g
        optimizer.step()
        loss = loss.detach()
        if not use_ps:
            n = 1
            for g in (group, st.dcn_group):
                if _h.group_size(g) > 1:
                    loss = _h.all_reduce_(loss, g)
                    n *= _h.group_size(g)
            if n > 1:
                loss = loss / n
        return loss

    return step


def make_async_train_step(
    loss_fn: Callable,
    optimizer: torch.optim.Optimizer,
    model,
    *,
    prefix: str = "aparam",
):
    """Asynchronous PS training (``BYTEPS_ENABLE_ASYNC=1`` on the fleet):
    the servers hold the parameters; each worker, at its own pace and with
    no per-round barrier, takes a local optimizer step, pushes the change
    of the parameters and pulls whatever they are now (stale gradients by
    design).

    Call on every worker with identical parameters before training: rank
    0's parameters (those in ``optimizer.param_groups``) seed the servers'
    copy through ``ps.ps_broadcast``. Returns ``step(batch) -> loss``:
    ``loss_fn(model, batch)``, backward, ``optimizer.step()``, the delta
    ``p_after - p_before`` pushed with ``async_mode=True`` and summed into
    the servers' copy, and the pulled copy written into the parameters.

    One process a host: a local group of more than one process is
    refused, as the JAX async step (one device, nothing reduced locally)
    has no local level.
    """
    from byteps_tpu_torch import ps as _ps

    st = bps._st()
    if not st.ps:
        raise RuntimeError(
            "make_async_train_step needs PS mode (DMLC_NUM_SERVER>0)")
    if _h.group_size(st.group) > 1:
        raise ValueError(
            f"make_async_train_step takes one process a host, not a local "
            f"group of {_h.group_size(st.group)}: the JAX package's async "
            "step runs on one device and reduces nothing locally, so the "
            "servers would apply each process's change as a host's")
    params = [p for g in optimizer.param_groups for p in g["params"]]
    # The deltas must land on the keys the seed initialised: both trees
    # have the parameters' shapes and dtypes and go through the same
    # prefix, so ps._tids gives them the same wire names (and the same
    # cached ids). Keys of their own would start from zero on the
    # servers, and the first delta would become the parameters.
    seeded = _ps.ps_broadcast([p.detach() for p in params], root_rank=0,
                              prefix=prefix)
    with torch.no_grad():
        for p, s in zip(params, seeded):
            p.copy_(s)

    def step(batch) -> torch.Tensor:
        before = [p.detach().clone() for p in params]
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            deltas = [p - b for p, b in zip(params, before)]
        fresh = _ps.ps_push_pull(deltas, average=False, prefix=prefix,
                                 async_mode=True)
        with torch.no_grad():
            for p, f in zip(params, fresh):
                p.copy_(f)
        return loss.detach()

    return step
