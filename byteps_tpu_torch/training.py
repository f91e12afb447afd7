"""The data-parallel training step.

Counterpart of ``make_train_step`` / ``_make_ps_train_step`` in
``byteps_tpu/jax/training.py``. The step runs backward, reduces the
gradients, and applies the optimizer:

- collective mode: the compression cast, the hierarchical all-reduce over
  the local process group, the cast back;
- PS mode: the local reduce, the compression cast, the host round trip
  through the CPU parameter servers (``ps_push_pull``), the cast back.

PyTorch runs eagerly, so there is nothing to jit or donate; the optimizer
updates the parameters in place. ``replicate`` and ``shard_batch`` have no
counterpart: broadcast the parameters with ``broadcast_parameters`` and
slice the global batch by ``rank()``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

import byteps_tpu_torch as bps
from byteps_tpu_torch.compression import Compression, Compressor
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
    mode, averaged over the local group. ``ps_prefix`` names the gradient
    tensors in the PS registry (PS mode only).
    """
    st = bps._st()
    use_ps = st.config.use_ps
    if use_ps and compression.name in ("int8_quant", "int8_quant_dcn"):
        raise ValueError(
            f"Compression {compression.name!r} (int8 quantized transport) "
            "only applies to collective mode. In PS mode use the C-core "
            "codec instead: declare tensors with a compressor config "
            "string (e.g. BYTEPS_COMPRESSOR=onebit or type=dithering;k=4), "
            "or use Compression.bf16/fp16 for a wire cast.")
    group = st.group
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def reduce(grads):
        dtypes = [g.dtype for g in grads]
        if use_ps:
            from byteps_tpu_torch.ps import ps_push_pull
            grads = _h.tree_all_reduce(grads, ici_group=group,
                                       average=average)
            wire = ps_push_pull([compression.compress(g) for g in grads],
                                average=average, prefix=ps_prefix)
        else:
            wire = _h.tree_all_reduce(
                [compression.compress(g) for g in grads], ici_group=group,
                average=average)
        return [compression.decompress(g, d) for g, d in zip(wire, dtypes)]

    def step(model_or_params, batch) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model_or_params, batch)
        loss.backward()
        live = [p for p in params if p.grad is not None]
        for p, g in zip(live, reduce([p.grad for p in live])):
            p.grad = g
        optimizer.step()
        loss = loss.detach()
        if not use_ps and _h.group_size(group) > 1:
            dist.all_reduce(loss, group=group)
            loss = loss / _h.group_size(group)
        return loss

    return step
