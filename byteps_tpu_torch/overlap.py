"""Per-parameter compute/communication overlap for PS-mode training.

Counterpart of ``byteps_tpu/jax/overlap.py``. The reference's torch
plugin registers per-parameter autograd hooks so each gradient starts its
push the moment backward produces it (byteps/torch/__init__.py
_make_hook): communication overlaps the rest of backward. JAX has no
hooks and recovers them with ``custom_vjp`` taps that fire
``io_callback``; PyTorch has them. Each parameter gets a
``register_post_accumulate_grad_hook``, which fires once the pass's
gradient is accumulated into ``.grad``. The hook only launches device
work and queues a record; it never blocks:

1. it casts (``bfloat16``, ``float16``) or blockwise int8-quantises the
   gradient, if the wire asks for it, on the stream current in the hook
   (the stream that produced the gradient);
2. it records an event there and queues (leaf, wire tensors, event) to
   one stager thread (``ps.Stager``);
3. the stager takes every leaf queued so far (with ``buckets``: every
   leaf of the bucket whose last leaf just arrived), makes a dedicated
   copy stream wait for their events, copies the wires ``non_blocking``
   into the leaves' persistent pinned host buffers, waits for the batch,
   re-expands each wire to f32 on the host (unless the servers sum the
   wire itself) and enqueues the core's ``push_pull``.

The copies are issued by the stager, not the hook: the hook runs on
autograd's thread between the backward's launches, and every call it
makes there, and every wait for the interpreter lock the stager holds,
delays the backward of a step that is bound by the host (measured:
``tools/overlap_cost.py``).

The core's push queue is priority-scheduled by declaration order, so the
tensors are declared once, in model order (front first), from the main
thread through the ordered bridge; hooks fire back to front and never
declare. After ``backward()`` returns the step waits the handles in model
order, uploads each sum into ``.grad`` on the copy stream, makes the
compute stream wait for the uploads, and runs ``optimizer.step()``.

The JAX module's ``io_callback_supported``, ``_effects_barrier``, bucketed
fallback and CPU-deadlock warning have no counterpart: hooks always run
in PyTorch, and joining the stager's queue is the effects barrier. A
parameter with no gradient never fires its hook (every JAX tap fires), so
the step names it as soon as ``backward()`` returns instead of waiting
for the tap timeout. PS mode runs one process per GPU with no local group,
so each leaf is one shard, ``{prefix}_{i}.0``; the JAX module's
reduce-scatter over local chips waits for multi-GPU-per-host PS.

Options: ``wire_dtype`` shrinks the device->host copy (bf16 2x, int8 +
per-block scales ~4x; the host pushes f32), and
``backward_passes_per_step`` accumulates K passes in ``.grad`` on the card
and communicates once, on the K-th (the reference's accumulation
contract). ``bucketed.py`` and the PS-mode ``DistributedOptimizer`` run on
the same ``_TapState``.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from functools import partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

import byteps_tpu_torch as bps
from byteps_tpu_torch import ps
from byteps_tpu_torch.parallel.hierarchical import _blockwise_quantize

WIRE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16,
               "float16": torch.float16, "int8": torch.int8}


class _TapState:
    """Declared tensors, host buffers, hooks and in-flight handles of one
    step builder (or one PS-mode ``DistributedOptimizer``).

    ``buckets`` (lists of leaf indices) makes the stager copy and push a
    bucket once its last leaf has its gradient, instead of every leaf
    queued so far. ``sum_wire`` has the servers sum a ``bfloat16`` or
    ``float16`` wire as it is (declared in that dtype, no host
    re-expansion), unless a codec is configured: the C codecs take f32.
    ``hooks=False`` registers none: the step stages the leaves itself."""

    def __init__(self, client, params, prefix: str, average: bool,
                 compression_config: Optional[str],
                 wire_dtype: str = "float32", wire_block: int = 256,
                 backward_passes_per_step: int = 1, *,
                 buckets: Optional[Sequence[Sequence[int]]] = None,
                 sum_wire: bool = False, hooks: bool = True):
        if wire_dtype not in WIRE_DTYPES:
            raise ValueError(f"wire_dtype must be one of "
                             f"{'|'.join(WIRE_DTYPES)}, got {wire_dtype!r}")
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self.client = client
        self.params = [p for p in params if p.requires_grad]
        self.prefix = prefix
        self.average = average
        self.compression_config = compression_config
        self.wire_dtype = wire_dtype
        self.wire_block = wire_block
        self.bpps = backward_passes_per_step
        self.sum_wire = (sum_wire and wire_dtype in ("bfloat16", "float16")
                         and not (compression_config
                                  or ps._codec_active(bps._st())))
        self.buckets = ([list(b) for b in buckets] if buckets is not None
                        else None)
        self.bucket_of = [0] * len(self.params)
        for b, idx in enumerate(self.buckets or ()):
            for i in idx:
                self.bucket_of[i] = b
        self.names: Dict[int, str] = {}  # id(param) -> name, for errors
        self.blocks: Dict[int, int] = {}
        self.shard_elems: Dict[int, int] = {}
        self.tids: Dict[int, int] = {}
        # leaf -> D2H destinations (the wire: the leaf's dtype, a half
        # dtype, or int8 codes and their scales) and the buffer the core
        # sums and pulls into (the wire buffer itself when it is pushed
        # as it is, else f32)
        self.wire_bufs: Dict[int, Tuple[torch.Tensor, ...]] = {}
        self.push_bufs: Dict[int, torch.Tensor] = {}
        self.cv = threading.Condition()
        self.passes = [0] * len(self.params)
        self.fired: set = set()
        # per bucket (one queue without buckets): (leaf, wire tensors on
        # the card, ready event) the hooks staged and the stager has not
        # copied yet; and the leaves each bucket still waits for
        self.staged = [collections.deque()
                       for _ in range(len(self.buckets or [()]))]
        self.left = [len(b) for b in self.buckets or ()]
        # leaf -> (handle, error): what the stager enqueued
        self.inflight: Dict[int, Tuple[Optional[int],
                                       Optional[Exception]]] = {}
        self.timeline: dict = {"pushes": [], "landed": None}
        cuda = [p.device for p in self.params if p.is_cuda]
        self.copy_stream = torch.cuda.Stream(cuda[0]) if cuda else None
        self.declare_all(self.params)
        self.stager = ps.Stager(f"bps_stager_{prefix}")
        self.hooks = [p.register_post_accumulate_grad_hook(
            partial(self._on_grad, i)) for i, p in enumerate(self.params)
        ] if hooks else []

    def pad_unit(self, idx: int) -> int:
        """Leaf ``idx``'s flat gradient is padded to this multiple (the
        int8 wire's block; the block shrinks with the leaf, so a 3-element
        bias is not padded out to 256 elements of PS traffic)."""
        return self.blocks[idx]

    def declare_all(self, leaves) -> None:
        """Declare every leaf in model order (the core's priority order)
        and allocate its host buffers once."""
        pin = self.copy_stream is not None
        wire = WIRE_DTYPES[self.wire_dtype]
        specs = []
        for i, leaf in enumerate(leaves):
            n = leaf.numel()
            self.blocks[i] = (min(self.wire_block, max(1, n))
                              if self.wire_dtype == "int8" else 1)
            unit = self.pad_unit(i)
            self.shard_elems[i] = -(-n // unit) * unit
            m = self.shard_elems[i]
            if wire is None or self.sum_wire:
                self.wire_bufs[i] = (ps.host_buffer(m, wire or leaf.dtype,
                                                    pin),)
                self.push_bufs[i] = self.wire_bufs[i][0]
            else:
                # cast and quantised wires land as f32 on the host (the C
                # codecs and summation operate on f32)
                self.wire_bufs[i] = (ps.host_buffer(m, wire, pin),) + (
                    (ps.host_buffer(m // unit, torch.float32, pin),)
                    if self.wire_dtype == "int8" else ())
                self.push_bufs[i] = ps.host_buffer(m, torch.float32, pin)
            specs.append((f"{self.prefix}_{i}.0", m,
                          ps._dtype_name(self.push_bufs[i]),
                          self.compression_config))
        for i, tid in enumerate(ps.declare_ordered(self.client, specs)):
            self.tids[i] = tid

    def learn_names(self, model_or_params) -> None:
        """Name the parameters in errors as ``named_parameters`` does."""
        if isinstance(model_or_params, torch.nn.Module) and not self.names:
            self.names.update((id(p), n) for n, p in
                              model_or_params.named_parameters())

    def _describe(self, i: int) -> str:
        p = self.params[i]
        return self.names.get(id(p), f"#{i} {list(p.shape)}")

    def wire(self, i: int):
        """Leaf ``i``'s gradient as the wire carries it, cast or
        quantised on the current stream, and an event marking it ready:
        the entry the stager copies."""
        g = self.params[i].grad.detach().reshape(-1)
        if self.wire_dtype == "int8":
            pad = self.shard_elems[i] - g.numel()
            if pad:
                g = torch.cat([g, g.new_zeros(pad)])
            srcs = _blockwise_quantize(g, self.blocks[i])
        elif WIRE_DTYPES[self.wire_dtype] is not None:
            srcs = (g.to(WIRE_DTYPES[self.wire_dtype]),)
        else:
            srcs = (g,)
        return i, srcs, ps.ready_event(srcs[0])

    def _on_grad(self, i: int, p: torch.Tensor) -> None:
        """The post-accumulate hook, on autograd's thread: launch the wire
        transform, record its event, queue the leaf for the stager."""
        if i in self.fired:
            # its push still reads, and its pull will write, the buffers
            raise RuntimeError(
                f"the gradient of parameter {self._describe(i)} was "
                "computed more than backward_passes_per_step times in one "
                "step; raise backward_passes_per_step to accumulate")
        self.passes[i] += 1
        if self.passes[i] < self.bpps:
            return
        self.passes[i] = 0
        self.fired.add(i)
        b = self.bucket_of[i]
        self.staged[b].append(self.wire(i))
        if self.buckets is None:
            self.stager.submit(self._drain, b)
            return
        self.left[b] -= 1
        if not self.left[b]:
            self.stager.submit(self._drain, b)

    def to_host(self, batch) -> None:
        """Copy the wires of ``batch`` [(leaf, wire tensors, event)] to
        their host buffers as one batch on the copy stream, behind the
        events, and wait for it."""
        done = ps.copy_to_host(
            [(src, buf) for i, srcs, _ in batch
             for src, buf in zip(srcs, self.wire_bufs[i])],
            [ev for _, _, ev in batch if ev is not None], self.copy_stream)
        if done is not None:
            done.synchronize()

    def _drain(self, b: int) -> None:
        """On the stager thread: copy what is staged in queue ``b`` to the
        host, then push each leaf (a bucket's in model order)."""
        batch = []
        while self.staged[b]:
            batch.append(self.staged[b].popleft())
        if not batch:
            return
        if self.buckets is not None:
            batch.sort(key=lambda e: e[0])
        try:
            self.to_host(batch)
        except Exception as e:  # noqa: BLE001 (raised by collect)
            for i, _, _ in batch:
                self._record(i, (None, e))
            return
        for i, _, _ in batch:
            self.push_shard(i)

    def _record(self, idx: int, rec) -> None:
        with self.cv:
            self.inflight[idx] = rec
            self.timeline["pushes"].append((time.perf_counter(),
                                            self.push_bufs[idx].nbytes))
            self.cv.notify_all()

    def push_shard(self, idx: int) -> None:
        """On the stager thread, once the D2H copy landed: re-expand the
        wire to f32 on the host where it is not pushed as it is, and
        enqueue the push_pull. A failure is recorded against the leaf,
        and ``collect`` raises it after settling the rest."""
        push = self.push_bufs[idx]
        try:
            wire = self.wire_bufs[idx]
            if self.wire_dtype == "int8":
                q, scales = wire
                torch.mul(q.view(-1, self.blocks[idx]), scales.view(-1, 1),
                          out=push.view(-1, self.blocks[idx]))
            elif wire[0] is not push:
                push.copy_(wire[0])
            rec = (ps.push_host(self.client, self.tids[idx], push,
                                self.average), None)
        except Exception as e:  # noqa: BLE001 (raised by collect)
            rec = (None, e)
        self._record(idx, rec)

    def reset_window(self) -> None:
        """Start an accumulation window with no pass counted and nothing
        in flight (``settle`` has run for any window that failed)."""
        with self.cv:
            self.passes = [0] * len(self.params)
            self.fired.clear()
            # a failed backward can leave a bucket staged but never full
            for queue in self.staged:
                queue.clear()
            self.left = [len(b) for b in self.buckets or ()]
            self.inflight.clear()
            self.timeline = {"pushes": [], "landed": None}

    def check_fired(self) -> None:
        """Raise, after settling what is in flight, naming every
        parameter whose gradient did not arrive in this step."""
        missing = [i for i in range(len(self.params)) if i not in self.fired]
        if missing:
            self.settle()
            raise RuntimeError(
                "no gradient reached parameter(s) "
                + ", ".join(self._describe(i) for i in missing)
                + " in this step, so their hooks never fired; take "
                "parameters that get no gradient out of the optimizer")

    def _pop(self, idx: int, deadline: float):
        """Wait until the stager has enqueued leaf ``idx``'s push, then
        take its handle; the stager runs behind the hooks, so a plain dict
        pop would race."""
        with self.cv:
            if not self.cv.wait_for(lambda: idx in self.inflight,
                                    max(0.0, deadline - time.monotonic())):
                return None, RuntimeError(
                    f"the gradient of parameter {self._describe(idx)} was "
                    "not pushed within "
                    f"BYTEPS_TAP_TIMEOUT_S (stager stuck or step crashed "
                    f"mid-backward)")
            return self.inflight.pop(idx)

    def collect(self, timeout: Optional[float] = None) -> None:
        """Wait every handle in model order and upload each sum into its
        ``.grad`` on the copy stream; the caller's stream then waits for
        the uploads. Raises, after settling every handle, when a
        parameter got no gradient or a push or pull failed."""
        self.check_fired()
        if timeout is None:
            timeout = float(os.environ.get("BYTEPS_TAP_TIMEOUT_S", "600"))
        deadline = time.monotonic() + timeout
        err = None
        for i, p in enumerate(self.params):
            h, e = self._pop(i, deadline)
            if e is None:
                try:
                    self.client.wait(h)
                except Exception as ex:  # noqa: BLE001 (settle all)
                    e = ex
            if e is not None:
                err = err or e
            elif err is None:
                self.upload(i)
        self.timeline["landed"] = time.perf_counter()
        if err is not None:
            self.settle()
            raise err
        self.join_uploads()

    def upload(self, i: int) -> None:
        """Queue leaf ``i``'s pulled sum into its ``.grad`` on the copy
        stream."""
        ps.copy_from_host([(self.push_bufs[i], self.params[i].grad)],
                          self.copy_stream)

    def join_uploads(self) -> None:
        """Make the caller's stream wait for the uploads."""
        if self.copy_stream is not None:
            torch.cuda.current_stream(self.copy_stream.device).wait_stream(
                self.copy_stream)

    def settle(self) -> None:
        """Wait out every queued push and every handle in flight,
        swallowing their errors (the caller raises its own): the core
        pulls into the host buffers in place, so none may be reused while
        a handle lives."""
        try:
            self.stager.join()
        except Exception:  # noqa: BLE001 (the caller's error wins)
            pass
        with self.cv:
            handles = [(h, None, None) for h, _ in self.inflight.values()
                       if h is not None]
            self.inflight.clear()
        try:
            ps._wait_all(self.client, handles)
        except Exception:  # noqa: BLE001 (the caller's error wins)
            pass

    def close(self) -> None:
        """Remove the hooks and stop the stager."""
        for h in self.hooks:
            h.remove()
        self.hooks = []
        self.stager.close()


def _hooked_step(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                 state: _TapState):
    """``step(model_or_params, batch) -> loss`` over ``state``'s hooks:
    backward (the hooks push), ``collect``, ``optimizer.step()``; K-pass
    accumulation windows as ``make_overlapped_train_step`` describes."""
    k = state.bpps
    micro = [0]

    def step(model_or_params, batch) -> torch.Tensor:
        state.learn_names(model_or_params)
        if micro[0] % k == 0:
            state.reset_window()
            optimizer.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        try:
            loss = loss_fn(model_or_params, batch)
            loss.backward()
            t_bwd = time.perf_counter()
            micro[0] += 1
            if micro[0] % k:
                return loss.detach()  # accumulation pass: nothing pushed
            state.collect()
        except BaseException:
            # A failure mid-window would count the failed pass twice on
            # a retry: roll back to the window start, so the next call
            # resets, and settle every handle before raising.
            micro[0] -= micro[0] % k
            state.settle()
            raise
        optimizer.step()
        step.timings = dict(state.timeline, start=t0, backward=t_bwd)
        return loss.detach()

    step.timings = {}
    step.close = state.close
    return step


def _optimizer_params(optimizer: torch.optim.Optimizer) -> List:
    return [p for g in optimizer.param_groups for p in g["params"]
            if p.requires_grad]


def make_overlapped_train_step(
    loss_fn: Callable,
    optimizer: torch.optim.Optimizer,
    *,
    average: bool = True,
    compression_config: Optional[str] = None,
    wire_dtype: str = "float32",
    wire_block: int = 256,
    backward_passes_per_step: int = 1,
    prefix: str = "ograd",
):
    """Build ``step(model_or_params, batch) -> loss`` with hook-streamed
    pushes (see the module docstring).

    ``loss_fn(model_or_params, batch)`` returns a scalar tensor; the
    gradients of the parameters in ``optimizer.param_groups`` are summed
    (mean with ``average``) across workers by the PS fleet and
    ``optimizer`` then updates them in place, as ``make_train_step``
    does. ``compression_config`` is the C-core codec string (e.g.
    ``"type=onebit;ef=vanilla"``) of every tensor's DCN leg. ``wire_dtype``
    shrinks the device->host copy: ``"bfloat16"`` (2x) or ``"int8"``
    (blockwise-quantised with one f32 scale per ``wire_block`` values,
    ~4x, not error-fed); the host re-expands to f32 before the push.
    ``backward_passes_per_step=K`` accumulates K passes in ``.grad`` on
    the card and communicates once, on the K-th; the other calls leave
    the parameters as they are, and dividing by K is the caller's (scale
    the learning rate). Every parameter of the optimizer must get a
    gradient in each pass. ``step.timings`` holds the last step's host
    clock readings: ``start``, ``backward`` (``backward()`` returned),
    ``pushes`` ([(enqueued, bytes)]) and ``landed`` (the last pull
    waited); ``step.close()`` removes the hooks.
    """
    client = bps._st().ps_client
    if client is None:
        raise RuntimeError(
            "make_overlapped_train_step needs PS mode (init with "
            "DMLC_NUM_SERVER>0 / BYTEPS_PS_MODE=ps)")
    if wire_dtype not in ("float32", "bfloat16", "int8"):
        raise ValueError(f"wire_dtype must be float32|bfloat16|int8, got "
                         f"{wire_dtype!r}")
    state = _TapState(client, _optimizer_params(optimizer), prefix, average,
                      compression_config, wire_dtype=wire_dtype,
                      wire_block=wire_block,
                      backward_passes_per_step=backward_passes_per_step)
    return _hooked_step(loss_fn, optimizer, state)
