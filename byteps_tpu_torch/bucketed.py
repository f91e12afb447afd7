"""Bucketed compute/communication overlap for PS-mode training.

Counterpart of ``byteps_tpu/jax/bucketed.py``. The parameters are split
into contiguous, byte-balanced **buckets** (model order; processed in
reverse, the order backward produces them), and each bucket crosses the
three host-boundary legs, D2H, the PS round trip and H2D, as one unit
instead of the tree crossing each leg whole. Both modes are
``overlap.py``'s ``_TapState`` with bucket flushes, driven by its one
step (``_hooked_step``): backward, ``collect``, ``optimizer.step()``.

* ``multi_program=True`` keeps the JAX module's contract: bucket b's D2H
  and push overlap the backward compute of the buckets after it. It does
  not keep its mechanism. JAX has no hooks, so it compiles one gradient
  program per bucket and pays for recomputing the forward and part of the
  backward in each. PyTorch has hooks: each parameter's hook stages its
  gradient, and the hook of a bucket's last leaf has the stager thread
  copy the bucket to the host on the copy stream and push it; one
  backward, no recompute.
* ``multi_program=False`` registers no hooks: once backward has returned,
  ``collect`` stages each bucket in backward order and copies and pushes
  it on the step's own thread, then waits the pulls in model order.

Either way the sums land in ``.grad`` on the copy stream, and the
optimizer steps once the compute stream has waited for the uploads. With
a local group of k > 1 processes a bucket is also the unit of the local
reduce-scatter, which ``_TapState``'s round issues bucket by bucket in
backward order on the bridge thread; ``multi_program=False`` then hands
every bucket to the same round after backward.
``donate`` has no counterpart: PyTorch updates the parameters in place,
as ``training.py`` does.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

import torch

import byteps_tpu_torch as bps
from byteps_tpu_torch.overlap import _hooked_step, _optimizer_params, _TapState


def partition_buckets(sizes: Sequence[int], n_buckets: int) -> List[List[int]]:
    """Split leaf indices into <=n_buckets contiguous groups balanced by
    byte size (greedy: close each bucket once it reaches the ideal
    share). Contiguity preserves model order, so reversed(buckets) is
    backward order — the order the reference's hooks fire in."""
    n_buckets = max(1, min(n_buckets, len(sizes)))
    total = sum(sizes) or 1
    ideal = total / n_buckets
    buckets: List[List[int]] = [[]]
    acc = 0
    for i, s in enumerate(sizes):
        remaining_leaves = len(sizes) - i
        remaining_buckets = n_buckets - len(buckets) + 1
        if (buckets[-1] and acc + s / 2 > ideal * len(buckets)
                and remaining_buckets > 1
                and remaining_leaves >= remaining_buckets):
            buckets.append([])
        buckets[-1].append(i)
        acc += s
    return buckets


def make_bucketed_overlap_step(
    loss_fn: Callable,
    optimizer: torch.optim.Optimizer,
    *,
    n_buckets: Optional[int] = None,
    multi_program: Optional[bool] = None,
    average: bool = True,
    wire_dtype: str = "float32",
    compression_config: Optional[str] = None,
    prefix: str = "bgrad",
):
    """Build ``step(model_or_params, batch) -> loss`` with bucketed-overlap
    PS communication (see the module docstring).

    ``loss_fn(model_or_params, batch)`` returns a scalar tensor; the
    gradients of the parameters in ``optimizer.param_groups`` are summed
    (mean with ``average``) by the PS fleet before ``optimizer.step()``.
    ``n_buckets`` defaults to ``BYTEPS_OVERLAP_BUCKETS`` (4).
    ``multi_program`` defaults to ``BYTEPS_BUCKET_PROGRAMS`` in
    {``multi``, ``single``} (multi): pushes start from the hooks while
    backward runs, or from the step's thread once it has returned.
    ``wire_dtype="bfloat16"`` casts the wire on the card (half the
    boundary bytes; the servers sum bf16, the upload casts back).
    ``compression_config`` is the C-core codec string applied per leaf on
    the DCN leg. ``step.timings`` holds the last step's host clock
    readings, as ``make_overlapped_train_step``'s do.
    """
    st = bps._st()
    if not st.ps:
        raise RuntimeError(
            "make_bucketed_overlap_step needs PS mode (init with "
            "DMLC_NUM_SERVER>0 / BYTEPS_PS_MODE=ps)")
    if wire_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"wire_dtype must be float32|bfloat16, got {wire_dtype!r}")
    if n_buckets is None:
        n_buckets = int(os.environ.get("BYTEPS_OVERLAP_BUCKETS", "4"))
    if n_buckets < 1:
        raise ValueError("n_buckets must be >= 1")
    if multi_program is None:
        multi_program = os.environ.get(
            "BYTEPS_BUCKET_PROGRAMS", "multi").lower() != "single"

    params = _optimizer_params(optimizer)
    buckets = partition_buckets(
        [p.numel() * p.element_size() for p in params], n_buckets)
    # Declared in MODEL order: declaration order is PS priority, and
    # front-of-model pulls are needed first by the next forward.
    state = _TapState(st.ps_client, params, prefix, average,
                      compression_config, wire_dtype=wire_dtype,
                      buckets=buckets, sum_wire=True, hooks=multi_program)
    return _hooked_step(loss_fn, optimizer, state)
