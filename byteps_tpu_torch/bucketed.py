"""Bucketed compute/communication overlap for PS-mode training.

Counterpart of ``byteps_tpu/jax/bucketed.py``. The parameters are split
into contiguous, byte-balanced **buckets** (model order; processed in
reverse, the order backward produces them), and each bucket crosses the
three host-boundary legs, D2H, the PS round trip and H2D, as one unit of
a pipeline instead of the tree crossing each leg whole:

* ``multi_program=True`` keeps the JAX module's contract: bucket b's D2H
  and push overlap the backward compute of the buckets after it. It does
  not keep its mechanism. JAX has no hooks, so it compiles one gradient
  program per bucket and pays for recomputing the forward and part of the
  backward in each. PyTorch has hooks: this is ``overlap.py``'s
  ``_TapState`` with bucket flushes. Each parameter's hook stages its
  gradient, and the hook of a bucket's last leaf has the stager thread
  copy the bucket to the host on the copy stream and push it; one
  backward, no recompute.
* ``multi_program=False`` runs one backward, then the bucket pipeline in
  backward order (``_BucketPipeline``): the D2H of bucket b overlaps the
  PS round trip of the buckets pushed before it and the H2D of those
  already pulled, and a bucket is uploaded as soon as all its pulls have
  landed (``sweep``).

Either way the sums land in ``.grad`` on the copy stream, and the
optimizer steps once the compute stream has waited for the uploads. With
a local group of k > 1 processes a bucket is also the unit of the local
reduce-scatter, which ``_TapState``'s round issues bucket by bucket in
backward order on the bridge thread (``overlap.py``);
``multi_program=False`` then stages every bucket after backward through
the same round.
``donate`` has no counterpart: PyTorch updates the parameters in place,
as ``training.py`` does.
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, Optional, Sequence

import torch

import byteps_tpu_torch as bps
from byteps_tpu_torch import ps
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


class _BucketPipeline:
    """Host-side leg pipeline over one step's buckets.

    Tracks each bucket's handles; uploads a bucket (``upload(leaf)`` for
    each of its leaves) the moment its pulls complete, so the H2D of
    bucket j rides under the D2H and round trip of buckets processed
    later. Every error path settles EVERY outstanding handle before
    raising: the core pulls into the host buffers in place.
    """

    def __init__(self, client, upload: Callable[[int], None]):
        self.client = client
        self.upload = upload
        # bucket_idx -> list of (handle, host buffer, leaf_idx)
        self.pending: dict = {}

    def push_bucket(self, b: int, tids, host_buffers, leaf_idx, average):
        # Register the bucket BEFORE the first enqueue: if push_pull
        # raises mid-bucket, the already-staged handles are visible to
        # settle_all() on the step's error path.
        staged: list = []
        self.pending[b] = staged
        for tid, buf, li in zip(tids, host_buffers, leaf_idx):
            staged.append((ps.push_host(self.client, tid, buf, average),
                           buf, li))

    def sweep(self):
        """Non-blocking: upload any bucket whose pulls have all landed.
        poll() raises on a failed handle; the caller's error path settles
        everything else via settle_all()."""
        done = [b for b, staged in self.pending.items()
                if all(self.client.poll(h) for h, _, _ in staged)]
        for b in done:
            self._upload(b)

    def _upload(self, b: int):
        for _, _, li in self.pending.pop(b):
            self.upload(li)

    def _settle_pending(self):
        """Wait out EVERY pending handle (never bail early: a reused host
        buffer with a live-server partition in flight is overwritten);
        return the first error, leaving ``pending`` for the caller."""
        err = None
        for staged in self.pending.values():
            try:
                ps._wait_all(self.client, staged)
            except Exception as e:  # noqa: BLE001 (settle every bucket)
                if err is None:
                    err = e
        return err

    def finish(self) -> None:
        """Wait out every remaining bucket and upload it."""
        err = self._settle_pending()
        if err is not None:
            self.pending.clear()
            raise err
        for b in sorted(self.pending):
            self._upload(b)
        self.pending.clear()

    def settle_all(self) -> None:
        """Quiet settle for error paths: waits everything out, swallows
        settle-time errors (the caller re-raises the original)."""
        self._settle_pending()
        self.pending.clear()


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
    backward runs, or after it in the leg pipeline only.
    ``wire_dtype="bfloat16"`` casts the wire on the card (half the
    boundary bytes; the servers sum bf16, the upload casts back).
    ``compression_config`` is the C-core codec string applied per leaf on
    the DCN leg. ``step.timings`` holds the last step's host clock
    readings, as ``make_overlapped_train_step``'s do.
    """
    st = bps._st()
    client = st.ps_client
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
    state = _TapState(client, params, prefix, average, compression_config,
                      wire_dtype=wire_dtype, buckets=buckets, sum_wire=True,
                      hooks=multi_program)
    if multi_program or state.k > 1:
        return _hooked_step(loss_fn, optimizer, state)

    def step(model_or_params, batch) -> torch.Tensor:
        state.learn_names(model_or_params)
        optimizer.zero_grad(set_to_none=True)
        state.reset_window()
        pipe = _BucketPipeline(client, state.upload)
        t0 = time.perf_counter()
        try:
            loss = loss_fn(model_or_params, batch)
            loss.backward()
            t_bwd = time.perf_counter()
            state.fired.update(i for i, p in enumerate(params)
                               if p.grad is not None)
            state.check_fired()
            for b in reversed(range(len(buckets))):  # backward order
                idx = buckets[b]
                state.to_host([state.wire(i) for i in idx])
                pipe.push_bucket(b, [state.tids[(i, 0)] for i in idx],
                                 [state.expand((i, 0)) for i in idx],
                                 idx, average)
                now = time.perf_counter()
                state.timeline["pushes"] += [
                    (now, state.push_bufs[(i, 0)].nbytes) for i in idx]
                pipe.sweep()
            pipe.finish()
        except BaseException:
            # Settle-before-raise, one level up from every fault site
            # (enqueue, poll, copy): no host buffer is reused while a
            # live-server partition can still write it.
            pipe.settle_all()
            raise
        state.timeline["landed"] = time.perf_counter()
        state.join_uploads()
        optimizer.step()
        step.timings = dict(state.timeline, start=t0, backward=t_bwd)
        return loss.detach()

    step.timings = {}
    step.close = state.close
    return step
