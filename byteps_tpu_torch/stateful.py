"""The data-parallel train step for models with BatchNorm state.

Counterpart of ``byteps_tpu/jax/flax_util.py``. flax threads the mutable
``batch_stats`` collection through the step; in PyTorch the forward in
train mode updates the BatchNorm buffers in place. So the step is the
forward and backward, the gradient reduce of ``training.make_train_step``
(the local all-reduce, then in PS mode the round trip through the
servers), the optimizer step, and then every buffer averaged over the
local process group (synchronous statistics; one process keeps its own).
The buffers are never pushed to the servers, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

import byteps_tpu_torch as bps
from byteps_tpu_torch.compression import Compression, Compressor
from byteps_tpu_torch.parallel import hierarchical as _h
from byteps_tpu_torch.training import make_train_step


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """log-softmax in f32, then the mean negative log-likelihood."""
    return F.nll_loss(F.log_softmax(logits.float(), dim=-1), labels)


def make_stateful_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    *,
    loss_fn: Callable = cross_entropy_loss,
    average: bool = True,
    compression: Compressor = Compression.none,
    ps_prefix: str = "grad",
    has_batch_stats: bool = True,
):
    """Build ``step((x, y)) -> loss`` for ``model`` in train mode.

    ``loss_fn(logits, labels)`` returns a scalar. The gradients of the
    parameters in ``optimizer.param_groups`` are reduced as
    ``make_train_step`` reduces them (mean with ``average``, else sum;
    ``compression`` and ``ps_prefix`` as there); with ``has_batch_stats``
    the model's buffers (BatchNorm's running statistics) are then averaged
    over the process groups. The returned loss is detached and, in
    collective mode, averaged over the process groups.
    """
    st = bps._st()
    groups = dict(ici_group=st.group, dcn_group=st.dcn_group)
    stats = list(model.buffers()) if has_batch_stats else []

    def forward_loss(m, batch):
        x, y = batch
        return loss_fn(m(x), y)

    train_step = make_train_step(forward_loss, optimizer, average=average,
                                 compression=compression,
                                 ps_prefix=ps_prefix)

    def step(batch) -> torch.Tensor:
        model.train()
        loss = train_step(model, batch)
        if stats and _h.group_size(st.group) * _h.group_size(
                st.dcn_group) > 1:
            with torch.no_grad():
                for b, mean in zip(stats, _h.tree_all_reduce(
                        stats, average=True, **groups)):
                    b.copy_(mean)
        return loss

    return step
