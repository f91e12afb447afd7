"""PyTorch <-> C++ parameter-server bridge (PS mode).

Counterpart of ``byteps_tpu/jax/ps.py``: the slow level of the hierarchy.
Gradients leave the card already reduced over the local group, cross the
host boundary once, and the C++ core partitions, priority-schedules and
pushes them over TCP to the CPU servers, which sum them; the core pulls
the sum back into the same host buffers. One BytePS worker per process.

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
"""

from __future__ import annotations

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
from byteps_tpu_torch.parallel.hierarchical import tree_flatten

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
# Seconds spent in the last ps_push_pull / ps_broadcast: the D2H copy
# (waited for), the core's push/sum/pull, and the H2D copy (waited for).
last_timings = {"d2h_s": 0.0, "core_s": 0.0, "h2d_s": 0.0}


def reset_declare_cache() -> None:
    _tid_cache.clear()


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


def _wire_plan(leaves, codec: bool):
    """Per-leaf (declare dtype, compression override):

    - float32 + codec: inherit the default codec (None).
    - bfloat16/float16 + codec: declare FLOAT32 and upcast the staged
      host buffer; the C codec takes the wire from there.
    - non-float leaves: declare with compression="" (quantising integers
      is meaningless and the core would reject them).
    """
    plan = []
    for leaf in leaves:
        name = _dtype_name(leaf)
        if not codec or name == "float32":
            plan.append((name, None))
        elif name in ("bfloat16", "float16"):
            plan.append(("float32", None))
        else:
            plan.append((name, ""))
    return plan


def _tids(client, prefix: str, leaves, plan):
    global declare_steps
    # Shape/dtype signature in the key: a same-named tree with different
    # leaf sizes must re-declare (the C core rejects size changes).
    sig = tuple((int(l.numel()), _dtype_name(l)) for l in leaves)
    key = (prefix, sig, tuple(p[0] for p in plan))
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


def _run_staged(tree, op, prefix, stream):
    """D2H, ``op(client, tid, array, wire_dtype)`` per leaf, wait all, H2D
    (the shared body of ps_push_pull and ps_broadcast)."""
    st = bps._st()
    client = st.ps_client
    if client is None:
        raise RuntimeError(
            "PS mode is not active (init with BYTEPS_PS_MODE=ps / "
            "DMLC_NUM_SERVER>0)")
    leaves, unflatten = tree_flatten(tree)
    if not leaves:
        return tree
    with (torch.cuda.stream(stream) if stream is not None
          else contextlib.nullcontext()):
        plan = _wire_plan(leaves, _codec_active(st))
        tids = _tids(client, prefix, leaves, plan)
        t0 = time.perf_counter()
        host = _stage_d2h(leaves, plan)
        t1 = time.perf_counter()
        staged = []
        for tid, h, leaf, (wire_dtype, _) in zip(tids, host, leaves, plan):
            staged.append((op(client, tid, _numpy_view(h), wire_dtype), h,
                           leaf))
        _wait_all(client, staged)
        t2 = time.perf_counter()
        out = _stage_h2d(host, leaves)
        t3 = time.perf_counter()
    last_timings.update(d2h_s=t1 - t0, core_s=t2 - t1, h2d_s=t3 - t2)
    return unflatten(out)


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
    def op(client, tid, arr, wire_dtype):
        return client.push_pull(tid, arr, average=average,
                                async_mode=mode, dtype=wire_dtype)

    mode = (bps._st().config.enable_async if async_mode is None
            else async_mode)
    return _run_ordered(_run_staged, tree, op, prefix, _caller_stream(tree))


def ps_broadcast(tree, root_rank: int = 0, prefix: str = "param"):
    """Weight sync across workers through the servers: every worker ends
    up holding ``root_rank``'s values. Bridge-thread ordered like
    ps_push_pull."""
    def op(client, tid, arr, wire_dtype):
        return client.broadcast(tid, arr, root_rank=root_rank,
                                dtype=wire_dtype)

    return _run_ordered(_run_staged, tree, op, prefix, _caller_stream(tree))


def ps_barrier() -> None:
    """Fleet-wide worker barrier through the scheduler."""
    st = bps._st()
    if st.ps_client is None:
        raise RuntimeError("PS mode is not active")
    st.ps_client.barrier()


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
                self._jobs.task_done()
