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

A local group of k > 1 processes (one a GPU) on a host: each gradient is
reduce-scattered over the group and each process's 1/k shard, already
averaged over k as the JAX tap's, crosses to the host; leaf i's shards
are the PS tensors ``{prefix}_{i}.{j}``, j < k, of ``shard_elems[i] =
padded / k`` elements, padded to k times the int8 block (the JAX
``_TapState``'s names, sizes and padding). The root (local rank 0)
declares all of them and holds the client; the others declare nothing.
The group's collectives must run in the same order on every process, and
hooks fire in the order of each process's own backward, so the hook only
records the gradient and its event; the window's round (``_run_local``)
issues each leaf's (or bucket's) reduce-scatter in one fixed order,
backward declaration order, waiting for the leaf's hook where it must.
It then casts or quantises the shard, copies it into the host's shared
staging (``local_stage.Segment``) and signals; the root pushes shard
``.j`` once rank j's signal has come. ``collect`` has the root wait the
pulls and signal each leaf; every process reads its shard back, and the
group all-gathers the leaves into ``.grad``. The round and ``collect``'s
all-gather run on the FIFO bridge thread (``ps.BridgeJobs``), where
every other collective of the group is issued too (``push_pull_async``,
``broadcast_parameters``), so all of them keep the caller's program
order on every process. A process that fails or is cancelled mid-step
leaves the group's collectives out of step: the group fails with it.

The JAX module's ``io_callback_supported``, ``_effects_barrier``, bucketed
fallback and CPU-deadlock warning have no counterpart: hooks always run
in PyTorch, and joining the stager's queue is the effects barrier. A
parameter with no gradient never fires its hook (every JAX tap fires), so
the step names it as soon as ``backward()`` returns instead of waiting
for the tap timeout.

Options: ``wire_dtype`` shrinks the device->host copy (bf16 2x, int8 +
per-block scales ~4x; the host pushes f32), and
``backward_passes_per_step`` accumulates K passes in ``.grad`` on the card
and communicates once, on the K-th (the reference's accumulation
contract). ``bucketed.py`` and the PS-mode ``DistributedOptimizer`` run on
the same ``_TapState``.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
import weakref
from functools import partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

import byteps_tpu_torch as bps
from byteps_tpu_torch import local_stage, ps
from byteps_tpu_torch.parallel import hierarchical as _h
from byteps_tpu_torch.parallel.hierarchical import _blockwise_quantize

WIRE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16,
               "float16": torch.float16, "int8": torch.int8}


class _Cancelled(Exception):
    """``settle`` stopped the window's local round."""


class _TapState:
    """Declared tensors, host buffers, hooks and in-flight handles of one
    step builder (or one PS-mode ``DistributedOptimizer``).

    ``client`` is the core's client, None on a local rank other than 0.
    ``buckets`` (lists of leaf indices) makes the stager copy and push a
    bucket once its last leaf has its gradient, instead of every leaf
    queued so far. ``sum_wire`` has the servers sum a ``bfloat16`` or
    ``float16`` wire as it is (declared in that dtype, no host
    re-expansion), unless a codec is configured: the C codecs take f32.
    ``hooks=False`` registers none: the step stages the leaves itself.
    Buffers, tensor ids and handles are keyed by (leaf, shard)."""

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
        st = bps._st()
        self.client = client
        self.group = st.group
        self.k = _h.group_size(st.group)
        self.me = _h.group_rank(st.group)
        self.params = [p for p in params if p.requires_grad]
        self.prefix = prefix
        self.average = average
        self.compression_config = compression_config
        self.wire_dtype = wire_dtype
        self.wire_block = wire_block
        self.bpps = backward_passes_per_step
        self.sum_wire = (sum_wire and wire_dtype in ("bfloat16", "float16")
                         and not (compression_config
                                  or ps._codec_active(st)))
        self.buckets = ([list(b) for b in buckets] if buckets is not None
                        else None)
        self.bucket_of = [0] * len(self.params)
        for b, idx in enumerate(self.buckets or ()):
            for i in idx:
                self.bucket_of[i] = b
        self.names: Dict[int, str] = {}  # id(param) -> name, for errors
        self.blocks: Dict[int, int] = {}
        self.shard_elems: Dict[int, int] = {}
        self.tids: Dict[Tuple[int, int], int] = {}
        # (leaf, shard) -> D2H destinations (the wire: the leaf's dtype, a
        # half dtype, or int8 codes and their scales) and the buffer the
        # core sums and pulls into (the wire buffer itself when it is
        # pushed as it is, else f32); in the host's shared staging with a
        # local group
        self.wire_bufs: Dict[Tuple[int, int], Tuple[torch.Tensor, ...]] = {}
        self.push_bufs: Dict[Tuple[int, int], torch.Tensor] = {}
        self.segment: Optional[local_stage.Segment] = None
        self.cv = threading.Condition()
        self.passes = [0] * len(self.params)
        self.fired: set = set()
        # per bucket (one queue without buckets): (leaf, wire tensors on
        # the card, ready event) the hooks staged and the stager has not
        # copied yet; and the leaves each bucket still waits for
        self.staged = [collections.deque()
                       for _ in range(len(self.buckets or [()]))]
        self.left = [len(b) for b in self.buckets or ()]
        # local group: leaf -> (gradient, ready event) the hooks recorded
        # and the round has not reduced yet; the round of the window
        self.ready: Dict[int, Tuple[torch.Tensor, object]] = {}
        self.cancelled = False
        self.round = 0
        # (leaf, shard) -> (handle, error): what the stager enqueued
        self.inflight: Dict[Tuple[int, int],
                            Tuple[Optional[int], Optional[Exception]]] = {}
        self.timeline: dict = self._new_timeline()
        cuda = [p.device for p in self.params if p.is_cuda]
        self.copy_stream = torch.cuda.Stream(cuda[0]) if cuda else None
        self.declare_all(self.params)
        self.stager = (ps.Stager(f"bps_stager_{prefix}") if self.k == 1
                       else ps.BridgeJobs())
        # A hook lives on its parameter, where the garbage collector does
        # not look: one that held this state would keep it, and every
        # parameter and gradient it lists, alive for the life of the
        # process. So the hooks hold it weakly, and once the state is
        # dropped its hooks are removed and its stager stopped.
        me = weakref.ref(self)
        self.hooks = [p.register_post_accumulate_grad_hook(
            partial(_hook, me, i)) for i, p in enumerate(self.params)
        ] if hooks else []
        self._release = weakref.finalize(self, _release, self.hooks,
                                         self.stager)
        self._release.atexit = False

    @staticmethod
    def _new_timeline() -> dict:
        """One window's host clock readings: pushes enqueued (this
        process's, with their bytes), slices staged into the host's
        shared staging (local group; with their bytes), ``landed`` (the
        last pull waited; a local group: the all-gather done), and the
        seconds of each leg of the local group's path."""
        return {"pushes": [], "staged": [], "landed": None,
                "split_s": dict.fromkeys(
                    ("reduce_scatter", "d2h", "core", "h2d", "all_gather"),
                    0.0)}

    def declare_all(self, leaves) -> None:
        """Declare every leaf's k shards in model order (the core's
        priority order; the root only) and allocate their host buffers
        once: private pinned buffers for one process, the host's shared
        staging for a local group. A leaf is padded to k times its int8
        block before it is scattered; the block shrinks with the leaf's
        shard, so a 3-element bias is not padded out to k * 256 elements
        of PS traffic."""
        k = self.k
        wire = WIRE_DTYPES[self.wire_dtype]
        specs, layout, decl = [], [], []
        for i, leaf in enumerate(leaves):
            n = leaf.numel()
            self.blocks[i] = (min(self.wire_block, max(1, -(-n // k)))
                              if self.wire_dtype == "int8" else 1)
            m = self.shard_elems[i] = _h.shard_elems(n, k, self.blocks[i])
            if wire is None or self.sum_wire:
                shard = [(m, wire or leaf.dtype)]  # pushed as it is
            else:
                # cast and quantised wires land as f32 on the host (the C
                # codecs and summation operate on f32): the wire, the
                # int8 scales, then the f32 buffer pushed
                shard = [(m, wire)] + (
                    [(m // self.blocks[i], torch.float32)]
                    if self.wire_dtype == "int8" else []) + [
                        (m, torch.float32)]
            for j in range(k):
                layout.append(((i, j), len(specs), len(shard)))
                specs += shard
                decl.append((f"{self.prefix}_{i}.{j}", m,
                             str(shard[-1][1]).replace("torch.", ""),
                             self.compression_config))
        if k == 1:
            pin = self.copy_stream is not None
            host = [ps.host_buffer(n, d, pin) for n, d in specs]
        else:
            self.segment = ps.new_segment(
                (self.prefix, tuple((p.numel(), str(p.dtype))
                                    for p in leaves), self.wire_dtype,
                 self.sum_wire), specs, len(leaves))
            host = self.segment.buffers
        for key, at, count in layout:
            own = host[at:at + count]
            self.push_bufs[key] = own[-1]
            self.wire_bufs[key] = tuple(own[:-1] if count > 1 else own)
        self.check_credit()
        if self.client is not None:
            ids = ps.declare_ordered(self.client, decl)
            self.tids.update(zip((key for key, _, _ in layout), ids))

    def check_credit(self) -> None:
        """Raise unless the core's push budget holds a whole step's pushes
        (the root's: every shard) when more than one host pushes. The core
        holds a push's credit until its pull returns, and a pull waits for
        every host's push of that key. Hooks queue the pushes as backward
        produces them, and the core admits the queued push of highest
        priority, so two hosts can admit different keys; once each has
        spent its budget on keys the other has not pushed, neither pull
        returns and the fleet hangs."""
        need = sum(b.nbytes for b in self.push_bufs.values())
        have = ps.credit_bytes(bps._st().config)
        hosts = bps._hosts()[1]
        if hosts > 1 and need > have:
            raise ValueError(
                f"hook-driven pushes of {need} bytes a step over "
                f"{hosts} workers need BYTEPS_SCHEDULING_CREDIT >= "
                f"{need} (now {have} bytes): with less, the workers can "
                "spend their budgets on different keys and wait for each "
                "other forever")

    def learn_names(self, model_or_params) -> None:
        """Name the parameters in errors as ``named_parameters`` does."""
        if isinstance(model_or_params, torch.nn.Module) and not self.names:
            self.names.update((id(p), n) for n, p in
                              model_or_params.named_parameters())

    def _describe(self, i: int) -> str:
        p = self.params[i]
        return self.names.get(id(p), f"#{i} {list(p.shape)}")

    def wire_of(self, i: int, g: torch.Tensor):
        """Leaf ``i``'s flat gradient shard ``g`` (``shard_elems[i]``
        elements) as the wire carries it: cast or int8-quantised (codes
        and per-block scales) on the current stream."""
        if self.wire_dtype == "int8":
            return _blockwise_quantize(g, self.blocks[i])
        if WIRE_DTYPES[self.wire_dtype] is not None:
            return (g.to(WIRE_DTYPES[self.wire_dtype]),)
        return (g,)

    def wire(self, i: int):
        """One process: leaf ``i``'s gradient as the wire carries it, cast
        or quantised on the current stream, and an event marking it
        ready: the entry the stager copies."""
        g = self.params[i].grad.detach().reshape(-1)
        pad = self.shard_elems[i] - g.numel()
        if pad and self.wire_dtype == "int8":
            g = torch.cat([g, g.new_zeros(pad)])
        srcs = self.wire_of(i, g)
        return i, srcs, ps.ready_event(srcs[0])

    def _on_grad(self, i: int, p: torch.Tensor) -> None:
        """The post-accumulate hook, on autograd's thread: launch the wire
        transform, record its event, queue the leaf for the stager (a
        local group: record the gradient and its event only)."""
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
        if self.k > 1:
            self._ready([i])
            return
        b = self.bucket_of[i]
        self.staged[b].append(self.wire(i))
        if self.buckets is None:
            self.stager.submit(self._drain, b)
            return
        self.left[b] -= 1
        if not self.left[b]:
            self.stager.submit(self._drain, b)

    def _ready(self, leaves) -> None:
        """Local group: the gradients of ``leaves`` are accumulated; the
        first of a window queues its round (``_run_local``) on the
        bridge."""
        with self.cv:
            first = len(self.fired) == len(leaves)
            for i in leaves:
                g = self.params[i].grad
                self.ready[i] = (g, ps.ready_event(g))
            self.cv.notify_all()
        if first:
            self.stager.submit(self._run_local)

    def to_host(self, batch) -> None:
        """Copy the wires of ``batch`` [(leaf, wire tensors, event)] to
        their host buffers as one batch on the copy stream, behind the
        events, and wait for it."""
        done = ps.copy_to_host(
            [(src, buf) for i, srcs, _ in batch
             for src, buf in zip(srcs, self.wire_bufs[(i, 0)])],
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
                self._record((i, 0), (None, e))
            return
        for i, _, _ in batch:
            self.push_shard((i, 0))

    def _await(self, i: int, deadline: float):
        """In the round: leaf ``i``'s (gradient, event), once its hook
        has recorded them."""
        with self.cv:
            if not self.cv.wait_for(lambda: i in self.ready or self.cancelled,
                                    max(0.0, deadline - time.monotonic())):
                raise RuntimeError(
                    f"the gradient of parameter {self._describe(i)} did "
                    "not arrive within BYTEPS_TAP_TIMEOUT_S")
            if self.cancelled:
                raise _Cancelled()
            return self.ready.pop(i)

    def _run_local(self) -> None:
        """On the bridge thread, once a window (local group of k > 1):
        each unit (a bucket, else a leaf) in backward declaration order,
        the same on every process: wait for its gradients, reduce-scatter
        them over the group (the local mean with ``average``), cast or
        quantise this process's shards, copy them into the shared staging
        and signal; the root then pushes shard ``.j`` of each leaf once
        rank j's has landed."""
        self.round += 1
        step = self.round
        units = ([list(b) for b in reversed(self.buckets)] if self.buckets
                 else [[i] for i in reversed(range(len(self.params)))])
        deadline = time.monotonic() + local_stage.timeout_s()
        split = self.timeline["split_s"]
        with (torch.cuda.stream(self.copy_stream) if self.copy_stream
              is not None else contextlib.nullcontext()):
            for unit in units:
                try:
                    got = [self._await(i, deadline) for i in unit]
                except _Cancelled:
                    return
                t0 = time.perf_counter()
                for g, ev in got:
                    if ev is not None:
                        self.copy_stream.wait_event(ev)
                        g.record_stream(self.copy_stream)
                shards = _h.sharded_reduce_scatter(
                    [g for g, _ in got], [self.shard_elems[i] for i in unit],
                    self.group)
                del got
                if self.average:
                    shards = [s / self.k for s in shards]
                t1 = time.perf_counter()
                done = ps.copy_to_host(
                    [(src, buf) for i, s in zip(unit, shards)
                     for src, buf in zip(self.wire_of(i, s),
                                         self.wire_bufs[(i, self.me)])],
                    [], self.copy_stream)
                if done is not None:
                    done.synchronize()
                t2 = time.perf_counter()
                for i in unit:
                    self.segment.land(i, step)
                    self.timeline["staged"].append((t2, sum(
                        b.nbytes for b in self.wire_bufs[(i, self.me)])))
                split["reduce_scatter"] += t1 - t0
                split["d2h"] += t2 - t1
                if self.client is None:
                    continue
                for i in unit:
                    for j in range(self.k):
                        self.segment.wait_landed(i, j, step,
                                                 self._describe(i))
                        self.push_shard((i, j))

    def _record(self, key, rec) -> None:
        with self.cv:
            self.inflight[key] = rec
            self.timeline["pushes"].append((time.perf_counter(),
                                            self.push_bufs[key].nbytes))
            self.cv.notify_all()

    def expand(self, key) -> torch.Tensor:
        """Shard ``key``'s (leaf, shard) buffer that the core sums, once
        its D2H copy landed: the wire re-expanded to f32 on the host where
        it is not pushed as it is."""
        push = self.push_bufs[key]
        wire = self.wire_bufs[key]
        if self.wire_dtype == "int8":
            q, scales = wire
            block = self.blocks[key[0]]
            torch.mul(q.view(-1, block), scales.view(-1, 1),
                      out=push.view(-1, block))
        elif wire[0] is not push:
            push.copy_(wire[0])
        return push

    def push_shard(self, key) -> None:
        """On the stager thread (a local group: the bridge, in its round),
        once the D2H copy of shard ``key`` (leaf, shard) landed:
        ``expand`` it and enqueue the push_pull. A failure is recorded
        against the shard, and ``collect`` raises it after settling the
        rest."""
        try:
            rec = (ps.push_host(self.client, self.tids[key],
                                self.expand(key), self.average), None)
        except Exception as e:  # noqa: BLE001 (raised by collect)
            rec = (None, e)
        self._record(key, rec)

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
            self.ready.clear()
            self.cancelled = False
            self.inflight.clear()
            self.timeline = self._new_timeline()

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

    def _pop(self, key, deadline: float):
        """Wait until the stager has enqueued shard ``key``'s push, then
        take its handle; the stager runs behind the hooks, so a plain dict
        pop would race."""
        with self.cv:
            if not self.cv.wait_for(lambda: key in self.inflight,
                                    max(0.0, deadline - time.monotonic())):
                return None, RuntimeError(
                    f"the gradient of parameter {self._describe(key[0])} "
                    "was not pushed within "
                    f"BYTEPS_TAP_TIMEOUT_S (stager stuck or step crashed "
                    f"mid-backward)")
            return self.inflight.pop(key)

    def _wait_shard(self, key, deadline: float):
        """The error of shard ``key``'s push and pull, once both are
        done (None when they succeeded)."""
        h, e = self._pop(key, deadline)
        if e is None:
            try:
                self.client.wait(h)
            except Exception as ex:  # noqa: BLE001 (settle all)
                e = ex
        return e

    def collect(self, timeout: Optional[float] = None) -> None:
        """Wait every handle in model order and upload each sum into its
        ``.grad`` on the copy stream; the caller's stream then waits for
        the uploads. Raises, after settling every handle, when a
        parameter got no gradient or a push or pull failed. A local group
        without hooks stages every gradient here, once backward has
        returned."""
        staged_here = self.k > 1 and not self.hooks
        if staged_here:
            self.fired.update(i for i, p in enumerate(self.params)
                              if p.grad is not None)
        self.check_fired()
        if staged_here:
            self._ready(range(len(self.params)))
        if timeout is None:
            timeout = local_stage.timeout_s()
        deadline = time.monotonic() + timeout
        if self.k > 1:
            ps.run_ordered_on(ps._caller_stream(self.params),
                              self._collect_local, deadline)
            return
        err = None
        for i in range(len(self.params)):
            e = self._wait_shard((i, 0), deadline)
            if e is not None:
                err = err or e
            elif err is None:
                self.upload(i)
        self.timeline["landed"] = time.perf_counter()
        if err is not None:
            self.settle()
            raise err
        self.join_uploads()

    def _collect_local(self, deadline: float) -> None:
        """``collect`` for a local group, on the bridge thread after the
        window's round (every collective of it issued, every shard
        pushed): the root waits the pulls leaf by leaf in model order and
        signals each; every process reads its shard of each leaf back as
        the root's signal comes, and the group all-gathers the leaves
        into ``.grad``."""
        split = self.timeline["split_s"]
        root = self.client is not None
        err = None
        try:
            self.stager.join()
        except Exception as e:  # noqa: BLE001 (the peers hear of it)
            err = e
        step = self.round
        t0 = time.perf_counter()
        dev = self.params[0].device
        mine = torch.empty(sum(self.shard_elems.values()),
                           dtype=torch.float32, device=dev)
        slices = list(mine.split([self.shard_elems[i]
                                  for i in range(len(self.params))]))
        for i in range(len(self.params)):
            if root:
                for j in range(self.k):
                    e = (self._wait_shard((i, j), deadline)
                         if err is None else None)
                    err = err or e
                self.segment.mark_pulled(i, step, err is None)
            elif err is None:
                try:
                    self.segment.wait_pulled(i, step, self._describe(i))
                except RuntimeError as e:
                    err = e
            if err is None:
                ps.copy_from_host([(self.push_bufs[(i, self.me)],
                                    slices[i])], self.copy_stream)
        t1 = time.perf_counter()
        if err is not None:
            self.settle()
            raise err
        self.join_uploads()
        if self.copy_stream is not None:
            torch.cuda.current_stream(dev).synchronize()
        t2 = time.perf_counter()
        flats = _h.sharded_all_gather(
            slices, [p.numel() for p in self.params], self.group)
        with torch.no_grad():
            for p, f in zip(self.params, flats):
                p.grad.copy_(f.view(p.shape))
        if self.copy_stream is not None:
            torch.cuda.current_stream(dev).synchronize()
        self.timeline["landed"] = t3 = time.perf_counter()
        split["core"] += t1 - t0
        split["h2d"] += t2 - t1
        split["all_gather"] += t3 - t2

    def upload(self, i: int) -> None:
        """Queue leaf ``i``'s pulled sum into its ``.grad`` on the copy
        stream."""
        ps.copy_from_host([(self.push_bufs[(i, 0)], self.params[i].grad)],
                          self.copy_stream)

    def join_uploads(self) -> None:
        """Make the caller's stream wait for the uploads."""
        if self.copy_stream is not None:
            torch.cuda.current_stream(self.copy_stream.device).wait_stream(
                self.copy_stream)

    def settle(self) -> None:
        """Stop the window's local round, wait out every queued push and
        every handle in flight, swallowing their errors (the caller raises
        its own): the core pulls into the host buffers in place, so none
        may be reused while a handle lives."""
        with self.cv:
            self.cancelled = True
            self.cv.notify_all()
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
        """Remove the hooks and stop the stager (dropping the state does
        the same)."""
        self._release()


def _hook(state_ref, i: int, p: torch.Tensor) -> None:
    state = state_ref()
    if state is not None:
        state._on_grad(i, p)


def _release(hooks, stager) -> None:
    for h in hooks:
        h.remove()
    hooks.clear()
    stager.close()


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
    ``pushes`` ([(enqueued, bytes)]; the root's, with a local group),
    ``staged`` (a local group: [(copied into the host staging, bytes)]),
    ``landed`` (the last pull waited; a local group: the all-gather into
    ``.grad`` done) and ``split_s`` (a local group: the seconds of its
    reduce-scatters, D2H copies, root core, H2D copies and all-gather);
    ``step.close()`` removes the hooks.
    """
    st = bps._st()
    if not st.ps:
        raise RuntimeError(
            "make_overlapped_train_step needs PS mode (init with "
            "DMLC_NUM_SERVER>0 / BYTEPS_PS_MODE=ps)")
    if wire_dtype not in ("float32", "bfloat16", "int8"):
        raise ValueError(f"wire_dtype must be float32|bfloat16|int8, got "
                         f"{wire_dtype!r}")
    state = _TapState(st.ps_client, _optimizer_params(optimizer), prefix,
                      average, compression_config, wire_dtype=wire_dtype,
                      wire_block=wire_block,
                      backward_passes_per_step=backward_passes_per_step)
    return _hooked_step(loss_fn, optimizer, state)
