"""PyTorch <-> C++ parameter-server bridge (PS mode).

Counterpart of ``byteps_tpu/jax/ps.py``: the slow level of the hierarchy.
Gradients leave the card already reduced over the local group, cross the
host boundary once, and the C++ core partitions, priority-schedules and
pushes them over TCP to the CPU servers, which sum them; the core pulls
the sum back into the same host buffers. One BytePS worker per host: with
a local group of k > 1 processes (one a GPU), only local rank 0 holds the
core's client, and the others reach the servers through it.

Host staging: one batched D2H of the whole tree into fresh contiguous
host tensors (pinned when the tree is on the card), handed to the core
through their numpy views, then one batched H2D on the caller's stream.

The overlapped steps (``overlap.py``, ``bucketed.py`` and the PS-mode
``DistributedOptimizer``) stage differently, with the pieces at the end
of this module: tensors declared once on the bridge thread
(``declare_ordered``), persistent host buffers, copies queued on a
dedicated copy stream behind events (``ready_event``, ``copy_to_host``,
``copy_from_host``), and one ``Stager`` thread between the copies and the
core's push queue.

With a local group of k > 1 (``local_push_pull``), the tree is
reduce-scattered over the group first; each rank copies only its 1/k
slice of each leaf into the host's shared staging
(``local_stage.Segment``); the root waits for every rank's slices,
pushes and pulls the whole leaves under the keys of the one-process step
(``_tids``), and signals; each rank reads its slice back, and the group
all-gathers.

A local group's collectives must be issued in one order on every rank,
and a process has several threads (the caller's, autograd's, the
bridge). So every collective of the group in PS mode runs on the FIFO
bridge thread, in the order the caller's program submits it:
``local_push_pull``, ``local_broadcast``, ``ps_barrier``, the making of
a segment (``new_segment``) and the hook paths' rounds (``BridgeJobs``).
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
import time
import traceback
import zlib
from typing import Optional

import numpy as np
import torch

import byteps_tpu_torch as bps
from byteps_tpu_torch import local_stage
from byteps_tpu_torch.parallel import hierarchical as _h
from byteps_tpu_torch.parallel.hierarchical import tree_flatten
from byteps_tpu_torch.utils import timeline as _tl

# --- ordered bridge execution ----------------------------------------------
# Wire keys are (declaration-order id << 16 | partition): worker.cc's
# Declare assigns ids by LOCAL declaration order, so every worker must
# declare tensors in the same order or the servers sum unrelated tensors
# under one key. A single FIFO bridge thread gives that order a single
# authority: every host-boundary PS op (sync or async) executes on it in
# submission order, and submissions happen in the caller's program order.
_pool = None
_pool_lock = threading.Lock()
_POOL_PREFIX = "bps_bridge"


def _ensure_pool():
    global _pool
    with _pool_lock:
        if _pool is None:
            import concurrent.futures
            _pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=_POOL_PREFIX)
        return _pool


def _on_pool_thread() -> bool:
    return threading.current_thread().name.startswith(_POOL_PREFIX)


def _run_ordered(fn, *args, **kwargs):
    """Execute fn on the bridge thread and wait. Re-entrant: a call that is
    already ON the bridge thread (an async op's PS leg) runs inline; a
    submit-and-wait there would deadlock the single-worker FIFO."""
    if _on_pool_thread():
        return fn(*args, **kwargs)
    return _ensure_pool().submit(fn, *args, **kwargs).result()


def submit_ordered(fn, *args, **kwargs):
    """Queue fn on the bridge thread and return the Future (the async
    handle path). Caller must not already be on the bridge thread."""
    assert not _on_pool_thread(), "async submit from the bridge thread"
    return _ensure_pool().submit(fn, *args, **kwargs)


def run_ordered_on(stream, fn, *args):
    """``_run_ordered`` with ``fn`` run under ``stream`` (the caller's
    current CUDA stream, ``_caller_stream``; None on the CPU), so that
    the bridge thread's copies and collectives follow the caller's
    work."""
    def run():
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            return fn(*args)
    return _run_ordered(run)


def drain_bridge() -> None:
    """Settle every queued bridge op and retire the pool (shutdown path:
    the C++ client must not be torn down under an in-flight async op)."""
    global _pool
    with _pool_lock:
        p, _pool = _pool, None
    if p is not None:
        p.shutdown(wait=True)


# (prefix, shape signature, wire dtypes) -> tensor ids. Declares are per
# tensor lifetime, not per step. Cleared by init()/shutdown().
_tid_cache: dict = {}
# Steps that declared at least one NEW tensor (after warm-up this must
# stop growing: one registration per tensor lifetime).
declare_steps: int = 0
# (prefix, shape signature, wire dtypes) -> the host's shared staging of
# that tree (local group of k > 1), made at its first use by every rank
# together. Closed by init()/shutdown().
_segments: dict = {}


def credit_bytes(config) -> int:
    """The core's push budget (``BYTEPS_SCHEDULING_CREDIT``, converted as
    worker.cc converts it): partition bytes admitted to the wire whose
    pull has not returned yet."""
    credit = config.scheduling_credit
    if 0 < credit < 1024:
        return credit * config.partition_bytes
    return credit if credit > 0 else 4 * config.partition_bytes


def reset_declare_cache() -> None:
    _tid_cache.clear()
    for seg in _segments.values():
        seg.close()
    _segments.clear()


def _dtype_name(t: torch.Tensor) -> str:
    """numpy-style dtype name ("float32", "bfloat16"), as the JAX bridge
    spells it, so wire names agree between the two."""
    return str(t.dtype).replace("torch.", "")


def _wait_all(client, staged):
    """Settle EVERY staged handle before surfacing a failure: bailing out
    at the first failed handle would free the host buffers of handles
    still in flight, and the core's pull callbacks would write into freed
    memory. Collect errors, wait everything, then re-raise the first."""
    first_err = None
    for h, _, _ in staged:
        try:
            client.wait(h)
        except Exception as e:  # noqa: BLE001 (must settle all handles)
            if first_err is None:
                first_err = e
    if first_err is not None:
        raise first_err


def _codec_active(st) -> bool:
    """A fleet-default codec (BYTEPS_COMPRESSOR) is configured. Mirrors
    the C core's rule: ANY non-empty config makes declares codec-bearing
    (and the codecs are float32-domain)."""
    import os
    return bool(getattr(st.config, "compressor", "")
                or os.environ.get("BYTEPS_COMPRESSOR", ""))


def _wire_plan(leaves, codec: bool, override: Optional[str] = None):
    """Per-leaf (declare dtype, compression override):

    - float32 + codec: the codec (None: inherit the default).
    - bfloat16/float16 + codec: declare FLOAT32 and upcast the staged
      host buffer; the C codec takes the wire from there.
    - non-float leaves: declare with compression="" (quantising integers
      is meaningless and the core would reject them).

    ``override`` is the codec ``declare(name, ..., compression_config=)``
    set for the tree's name: it replaces the fleet default (``codec``),
    and ``""`` turns the codec off.
    """
    if override is not None:
        codec = bool(override)
    plan = []
    for leaf in leaves:
        name = _dtype_name(leaf)
        if not codec:
            plan.append((name, override))
        elif name in ("float32", "bfloat16", "float16"):
            plan.append(("float32", override))
        else:
            plan.append((name, ""))
    return plan


def _tree_key(prefix: str, leaves, plan, override: Optional[str] = None):
    # Shape/dtype signature in the key: a same-named tree with different
    # leaf sizes must re-declare (the C core rejects size changes). A
    # codec that ``declare`` set for the name goes in too, so that the
    # name declares tensors of its own (with fresh error-feedback state);
    # without one the key is the JAX bridge's.
    sig = tuple((int(l.numel()), _dtype_name(l)) for l in leaves)
    key = (prefix, sig, tuple(p[0] for p in plan))
    return key if override is None else key + (override,)


def _tids(client, prefix: str, leaves, plan,
          override: Optional[str] = None):
    global declare_steps
    key = _tree_key(prefix, leaves, plan, override)
    tids = _tid_cache.get(key)
    if tids is None:
        declare_steps += 1
        # The signature's digest goes INTO the wire name, so two trees of
        # different shapes under one prefix land on distinct server
        # tensors; crc32 is the same on every worker (hash() is salted).
        shape_key = zlib.crc32(repr(key).encode())
        tids = [
            client.declare(f"{prefix}_{shape_key:08x}_{i}", int(leaf.numel()),
                           wire_dtype, compression=comp)
            for i, (leaf, (wire_dtype, comp)) in enumerate(zip(leaves,
                                                               plan))
        ]
        _tid_cache[key] = tids
    return tids


def _numpy_view(host: torch.Tensor) -> np.ndarray:
    """numpy view of a contiguous CPU tensor (bfloat16 as 16-bit words)."""
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().reshape(-1)
    return host.numpy().reshape(-1)


def _stage_d2h(leaves, plan):
    """ONE batched D2H: every leaf copied into a fresh contiguous host
    tensor (pinned when it comes from the card), then one wait. Fresh
    buffers never alias a tensor still in use: the core pulls into them
    in place."""
    pin = any(leaf.is_cuda for leaf in leaves)
    host = []
    for leaf in leaves:
        h = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=pin)
        h.copy_(leaf.detach(), non_blocking=pin)
        host.append(h)
    if pin:
        torch.cuda.current_stream().synchronize()
    # half-wire + codec: the staged buffer is upcast to the f32 wire
    return [h if _dtype_name(h) == wire else h.to(getattr(torch, wire))
            for h, (wire, _) in zip(host, plan)]


def _stage_h2d(host, leaves):
    """ONE batched H2D back to each leaf's device and dtype (downcast on
    the host first, so the upload carries the leaf's bytes), on the
    current stream, then one wait."""
    out = []
    for h, leaf in zip(host, leaves):
        h = h if h.dtype == leaf.dtype else h.to(leaf.dtype)
        out.append(h.to(leaf.device, non_blocking=True).reshape(leaf.shape))
    if any(leaf.is_cuda for leaf in leaves):
        torch.cuda.current_stream().synchronize()
    return out


def _exchange(client, prefix, leaves, plan, host, op,
              override: Optional[str] = None) -> int:
    """The core's leg of a tree: ``op(client, tid, array, wire_dtype)``
    on each leaf's host buffer under the tree's tensor ids (``_tids``;
    ``override`` is the codec ``declare`` set for ``prefix``),
    every one enqueued before any wait, then every handle waited, those
    enqueued before a failed enqueue too (the core writes into the
    buffers in place). Returns the bytes handed to the core."""
    tids = _tids(client, prefix, leaves, plan, override)
    staged = []
    try:
        for tid, h, (wire_dtype, _) in zip(tids, host, plan):
            staged.append((op(client, tid, _numpy_view(h), wire_dtype), h,
                           None))
    finally:
        _wait_all(client, staged)
    return sum(h.nbytes for h in host)


def _push_pull_op(average: bool, async_mode: bool):
    def op(client, tid, arr, wire_dtype):
        return client.push_pull(tid, arr, average=average,
                                async_mode=async_mode, dtype=wire_dtype)
    return op


def _run_staged(tree, op, prefix, stream):
    """D2H, the core's leg (``_exchange``), H2D (the shared body of
    ps_push_pull and ps_broadcast)."""
    st = bps._st()
    client = st.ps_client
    if client is None:
        raise RuntimeError(
            "this process holds no PS client: PS mode is not active (init "
            "with BYTEPS_PS_MODE=ps / DMLC_NUM_SERVER>0), or it is a local "
            "rank other than 0 of a local group")
    leaves, unflatten = tree_flatten(tree)
    if not leaves:
        return tree
    with (torch.cuda.stream(stream) if stream is not None
          else contextlib.nullcontext()):
        override = st.codecs.get(prefix)
        plan = _wire_plan(leaves, _codec_active(st), override)
        t0 = time.perf_counter()
        host = _stage_d2h(leaves, plan)
        t1 = time.perf_counter()
        pushed = _exchange(client, prefix, leaves, plan, host, op, override)
        t2 = time.perf_counter()
        out = _stage_h2d(host, leaves)
        t3 = time.perf_counter()
    tr = _tl.steps
    if tr is not None:
        _legs(tr.current(), (("d2h", t0, t1, pushed),
                             ("core", t1, t2, pushed),
                             ("h2d", t2, t3, pushed)))
    return unflatten(out)


def _legs(rec: dict, legs) -> None:
    """The plain path's legs [(name, start, end, bytes)] as spans of the
    step trace's record ``rec``, under the parent "push_pull"."""
    for name, start, end, nbytes in legs:
        _tl.add_span(rec, name, start, end, "push_pull", nbytes=nbytes)


def _caller_stream(tree):
    leaves, _ = tree_flatten(tree)
    for leaf in leaves:
        if leaf.is_cuda:
            return torch.cuda.current_stream(leaf.device)
    return None


def ps_push_pull(tree, average: bool = True, prefix: str = "grad",
                 async_mode: Optional[bool] = None):
    """Sum (or average) a tensor, list or dict of tensors across workers
    through the CPU PS fleet. Every leaf is enqueued before any wait, so
    partitions of all tensors pipeline through the priority-scheduled
    push queue together. Runs on the FIFO bridge thread so declares keep
    a fleet-consistent order against async ops; the copies run on the
    caller's current stream."""
    mode = (bps._st().config.enable_async if async_mode is None
            else async_mode)
    return _run_ordered(_run_staged, tree, _push_pull_op(average, mode),
                        prefix, _caller_stream(tree))


def ps_broadcast(tree, root_rank: int = 0, prefix: str = "param"):
    """Weight sync across workers through the servers: every worker ends
    up holding ``root_rank``'s values. Bridge-thread ordered like
    ps_push_pull."""
    def op(client, tid, arr, wire_dtype):
        return client.broadcast(tid, arr, root_rank=root_rank,
                                dtype=wire_dtype)

    return _run_ordered(_run_staged, tree, op, prefix, _caller_stream(tree))


def local_broadcast(leaves, root_rank: int, prefix: str):
    """``broadcast_parameters`` in PS mode, in three stages: over the
    local group from ``root_rank``'s local rank, through the servers
    between the hosts' roots from ``root_rank``'s host (``ps_broadcast``),
    over the local group from its root. Returns the broadcast copies. On
    the FIFO bridge thread, as ``local_push_pull``."""
    st = bps._st()
    k = _h.group_size(st.group)

    def run():
        synced = _h.tree_broadcast(leaves, root=root_rank % k,
                                   ici_group=st.group)
        if st.ps_client is not None:
            synced = ps_broadcast(synced, root_rank=root_rank // k,
                                  prefix=prefix)
        if k > 1:
            synced = _h.tree_broadcast(synced, root=0, ici_group=st.group)
        return synced

    return run_ordered_on(_caller_stream(leaves), run)


def ps_barrier() -> None:
    """Fleet-wide worker barrier through the scheduler (with a local
    group: the group, the roots through the scheduler, the group, on the
    bridge thread)."""
    st = bps._st()
    if not st.ps:
        raise RuntimeError("PS mode is not active")
    if _h.group_size(st.group) == 1:
        st.ps_client.barrier()
        return

    def run():
        torch.distributed.barrier(group=st.group)
        if st.ps_client is not None:
            st.ps_client.barrier()
        torch.distributed.barrier(group=st.group)

    _run_ordered(run)


# --- a local group of k > 1 processes ----------------------------------------

def new_segment(key, specs, n_leaves: int) -> local_stage.Segment:
    """A shared staging of the host for ``key`` (a tuple whose first
    item is the prefix), made by every rank of the local group together
    (``local_stage.Segment``). Its file is named by the scheduler's port,
    this host's index, the prefix and the key's crc, so that two trees,
    two hosts on one machine or two fleets never meet in one name. Made
    on the bridge thread, as its group's collectives must be."""
    st = bps._st()
    tag = "".join(c if c.isalnum() else "_" for c in key[0])
    crc = zlib.crc32(repr(key).encode())
    name = f"bps_{st.config.root_port}_{bps._hosts()[0]}_{tag}_{crc:08x}"
    return _run_ordered(local_stage.Segment, st.group, name, specs,
                        n_leaves, st.device)


def segment(key, specs, n_leaves: int) -> local_stage.Segment:
    """The staging of the tree ``key`` (prefix, signature, wire dtypes)
    for ``local_push_pull``, made at its first use."""
    seg = _segments.get(key)
    if seg is None:
        seg = _segments[key] = new_segment(key, specs, n_leaves)
    return seg


def _local_leg(slices, numels, average: bool, prefix: str, compression,
               marks: dict):
    """``tree_sharded_all_reduce``'s leg in PS mode: this rank's slices
    (its 1/k of each leaf, reduced over the local group) through the
    host's shared staging and the root's core client; returns the slices
    summed (averaged) over the hosts."""
    st = bps._st()
    k, me = _h.group_size(st.group), _h.group_rank(st.group)
    marks["leg"] = time.perf_counter()
    wires = [compression.compress(s) for s in slices]
    metas = [torch.empty(n, dtype=w.dtype, device="meta")
             for n, w in zip(numels, wires)]
    override = st.codecs.get(prefix)
    plan = _wire_plan(metas, _codec_active(st), override)
    dtypes = [getattr(torch, wire) for wire, _ in plan]
    seg = segment(_tree_key(prefix, metas, plan, override),
                  [(k * w.numel(), d) for w, d in zip(wires, dtypes)],
                  len(wires))
    seg.round += 1
    step = seg.round
    mine = [buf[me * w.numel():(me + 1) * w.numel()]
            for buf, w in zip(seg.buffers, wires)]
    pin = seg.pinned
    for dst, w, d in zip(mine, wires, dtypes):
        dst.copy_(w.to(d), non_blocking=pin)
    if pin:
        torch.cuda.current_stream().synchronize()
    for i in range(len(wires)):
        seg.land(i, step)
    t1 = time.perf_counter()
    what = [f"leaf {i} of {prefix!r}" for i in range(len(wires))]
    pushed = 0
    if st.ps_client is not None:
        ok = False
        try:
            for i in range(len(wires)):
                for j in range(k):
                    seg.wait_landed(i, j, step, what[i])
            pushed = _exchange(
                st.ps_client, prefix, metas, plan,
                [buf[:n] for buf, n in zip(seg.buffers, numels)],
                _push_pull_op(average, st.config.enable_async), override)
            ok = True
        finally:
            for i in range(len(wires)):
                seg.mark_pulled(i, step, ok)
    else:
        for i in range(len(wires)):
            seg.wait_pulled(i, step, what[i])
    t2 = time.perf_counter()
    out = [compression.decompress(
        src.to(s.device, non_blocking=pin).to(w.dtype), s.dtype)
        for src, s, w in zip(mine, slices, wires)]
    if pin:
        torch.cuda.current_stream().synchronize()
    marks["end"] = time.perf_counter()
    tr = _tl.steps
    if tr is not None:
        _legs(tr.current(), (
            ("d2h", marks["leg"], t1, sum(m.nbytes for m in mine)),
            ("core", t1, t2, pushed), ("h2d", t2, marks["end"], 0)))
    return out


def local_push_pull(leaves, average: bool, prefix: str, compression):
    """Sum (or average) a list of tensors across every process of the
    fleet, in PS mode with a local group of k > 1: the local
    reduce-scatter (the local mean with ``average``), the PS leg of each
    rank's slices through the host's shared staging (``_local_leg``), and
    the local all-gather; ``compression`` casts the slices for the PS leg.
    Every rank calls it with its own tensors, in the same order. Runs on
    the FIFO bridge thread, so its collectives keep one order against
    ``push_pull_async``; the copies run on the caller's current
    stream."""
    st = bps._st()
    stream = _caller_stream(leaves)

    def run():
        marks = {}
        t0 = time.perf_counter()
        out = _h.tree_sharded_all_reduce(
            leaves, group=st.group, average=average,
            leg=lambda s: _local_leg(s, [l.numel() for l in leaves],
                                     average, prefix, compression, marks))
        if stream is not None:
            stream.synchronize()
        tr = _tl.steps
        if tr is not None:
            _legs(tr.current(), (
                ("reduce_scatter", t0, marks["leg"], 0),
                ("all_gather", marks["end"], time.perf_counter(), 0)))
        return out

    return run_ordered_on(stream, run)


# --- staging for the overlapped steps ----------------------------------------

def declare_ordered(client, specs):
    """Declare ``specs``, (name, numel, wire dtype name, compression) in
    priority order (front of the model first), on the bridge thread, and
    return their ids. Wire ids follow declaration order, so a gradient
    hook, which fires back to front, never declares."""
    return _run_ordered(lambda: [
        client.declare(name, numel, dtype, compression=comp)
        for name, numel, dtype, comp in specs])


def host_buffer(numel: int, dtype: torch.dtype, pin: bool) -> torch.Tensor:
    """A flat host buffer that lives as long as its declared tensor: the
    D2H destination, the array the core sums and pulls into in place, and
    the H2D source. Pinned for a card, so copies to and from it run
    asynchronously; reused only after its handle was waited."""
    return torch.empty(numel, dtype=dtype, pin_memory=pin)


def push_host(client, tid: int, buf: torch.Tensor, average: bool) -> int:
    """Enqueue the push_pull of host buffer ``buf``; the core sums into
    it in place. Returns the handle."""
    return client.push_pull(tid, _numpy_view(buf), average=average,
                            dtype=_dtype_name(buf))


def ready_event(t: torch.Tensor):
    """An event on the stream current for ``t``'s device (in a gradient
    hook, the stream that produced the gradient); None on the CPU."""
    if not t.is_cuda:
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


def copy_to_host(pairs, ready, copy_stream):
    """Queue the D2H copies of ``pairs`` (device source, host buffer) on
    ``copy_stream`` behind the events in ``ready``, and return the event
    that marks them done; the calling thread does not wait. Each source
    is marked in use by the copy stream, so the caching allocator does not
    give its memory to the compute stream (after ``zero_grad``, or when a
    cast temporary dies) before the copy has read it. On the CPU
    (``copy_stream`` None) the copies run at once and None is returned."""
    if copy_stream is None:
        for src, dst in pairs:
            dst.copy_(src.reshape(-1))
        return None
    for ev in ready:
        copy_stream.wait_event(ev)
    with torch.cuda.stream(copy_stream):
        for src, dst in pairs:
            dst.copy_(src.reshape(-1), non_blocking=True)
            src.record_stream(copy_stream)
        done = torch.cuda.Event()
        done.record(copy_stream)
    return done


def copy_from_host(pairs, copy_stream) -> None:
    """Queue the H2D copies of ``pairs`` (host buffer, device destination
    of the buffer's first ``numel`` elements) on ``copy_stream``. The
    caller's stream waits for ``copy_stream`` before it reads a
    destination."""
    if copy_stream is None:
        for src, dst in pairs:
            dst.copy_(src[:dst.numel()].view(dst.shape))
        return
    with torch.cuda.stream(copy_stream):
        for src, dst in pairs:
            src = src[:dst.numel()].view(dst.shape)
            if src.dtype != dst.dtype:
                src = src.to(dst.device, non_blocking=True)
            dst.copy_(src, non_blocking=True)


class Stager:
    """One daemon thread that runs queued jobs in FIFO order: the leg
    between a gradient's D2H copy and the core's push queue, so that a
    gradient hook only launches device work and never blocks. ``join``
    returns once every job queued so far has run (the overlapped steps'
    effects barrier) and raises the first error a job let escape."""

    def __init__(self, name: str):
        self._jobs: queue.Queue = queue.Queue()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def submit(self, fn, *args) -> None:
        self._jobs.put((fn, args))

    def join(self) -> None:
        self._jobs.join()
        err, self._error = self._error, None
        if err is not None:
            raise err

    def close(self) -> None:
        self._jobs.put(None)
        # the last reference to its owner may drop on this very thread
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=60)

    def _run(self) -> None:
        while True:
            job = self._jobs.get()
            try:
                if job is None:
                    return
                fn, args = job
                fn(*args)
            except Exception as e:  # noqa: BLE001 (the thread must live on)
                traceback.print_exc()
                if self._error is None:
                    self._error = e
            finally:
                # hold no job while idle: its function may be a bound
                # method of an owner that is to be freed
                job = fn = args = None
                self._jobs.task_done()


class BridgeJobs:
    """``Stager``'s interface over the FIFO bridge thread, for the hook
    paths of a local group of k > 1: their rounds issue the group's
    collectives, so they take their place in the bridge's one order
    (submitted from a hook, that order is the caller's program order on
    every rank, since the caller is inside backward()). ``join`` raises
    the first error of the jobs submitted since the last join; on the
    bridge thread it may wait only for jobs submitted before the one
    running."""

    def __init__(self):
        self._jobs: collections.deque = collections.deque()

    def submit(self, fn, *args) -> None:
        self._jobs.append(submit_ordered(fn, *args))

    def join(self) -> None:
        err = None
        while self._jobs:
            e = self._jobs.popleft().exception()
            err = err or e
        if err is not None:
            raise err

    def close(self) -> None:
        """Nothing to stop: the bridge outlives its jobs."""
