"""Host staging that the k processes of one host share (PS mode with a
local group of k > 1).

One JAX controller drives every chip of its host, so its PS leg stages
the chips' shards in its own memory. The reference runs one process per
GPU and shares a segment of host memory between them
(``shared_memory.cc``), through which one process, the local root, talks
to the servers (``communicator.cc``). This module is that segment:

- ``Segment(group, name, specs, n_leaves, device)`` is collective over the
  local group. Rank 0 creates a file of the size every buffer needs
  (``stage_dir``), the others open it, each maps it shared, and once
  every rank has mapped it rank 0 unlinks the file: the mapping lives on
  and a fleet that is killed leaves no file behind.
- ``buffers`` are flat CPU tensors over the mapping, one per (numel,
  dtype) of ``specs``, 64-byte aligned: the D2H destinations, the arrays
  the root's core client pushes and pulls into in place, and the H2D
  sources. When ``device`` is a card the mapping is pinned
  (``cudaHostRegister``), so copies to and from it run asynchronously.
- Signals, one int64 cell each at the head of the mapping: ``landed[leaf,
  rank]`` is the round whose slice of ``leaf`` rank ``rank`` has copied
  into the segment, written once the copy's event has been waited;
  ``pulled[leaf]`` is the round whose pull of ``leaf`` the root has
  waited (its negative when the root's push or pull failed). Rounds
  count from 1. A rank reads its slice back only after ``pulled``, and
  copies the next round's slice in only after that read (one copy
  stream, or one thread, orders the two), so a round never overwrites a
  slice the root still pushes. Each cell is one aligned 8-byte store,
  written after the data it announces (x86-64 keeps stores in order).

Every wait polls its cell until ``BYTEPS_TAP_TIMEOUT_S`` (600 s) has
passed, then raises naming the leaf and the rank it waited for.
"""

from __future__ import annotations

import mmap
import os
import tempfile
import time
import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

ALIGN = 64


def stage_dir(nbytes: int) -> str:
    """Where a segment of ``nbytes`` is created: ``BYTEPS_LOCAL_STAGE_DIR``
    when set; else ``/dev/shm`` when it is a directory with room for the
    segment (memory-backed, as the reference's shared memory is); else the
    temporary directory. The choice is made once, before the file is
    created: a failure to create or map it raises."""
    chosen = os.environ.get("BYTEPS_LOCAL_STAGE_DIR")
    if chosen:
        return chosen
    if os.path.isdir("/dev/shm"):
        fs = os.statvfs("/dev/shm")
        if fs.f_bavail * fs.f_frsize >= nbytes:
            return "/dev/shm"
    return tempfile.gettempdir()


def timeout_s() -> float:
    return float(os.environ.get("BYTEPS_TAP_TIMEOUT_S", "600"))


def _layout(specs, n_leaves: int, k: int):
    """(offsets of the buffers, total bytes): the signal cells first."""
    off = -(-8 * (n_leaves * k + n_leaves) // ALIGN) * ALIGN
    offsets = []
    for numel, dtype in specs:
        offsets.append(off)
        nbytes = numel * torch.empty((), dtype=dtype).element_size()
        off += -(-nbytes // ALIGN) * ALIGN
    return offsets, max(off, ALIGN)


def _unpin(ptr: int) -> None:
    torch.cuda.check_error(torch.cuda.cudart().cudaHostUnregister(ptr))


class Segment:
    """One host's shared staging for one tree (see the module
    docstring). ``round`` is advanced by the caller, once a use, in the
    same order on every rank."""

    def __init__(self, group, name: str,
                 specs: Sequence[Tuple[int, torch.dtype]], n_leaves: int,
                 device: torch.device):
        self.k = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.round = 0
        offsets, size = _layout(specs, n_leaves, self.k)
        root = dist.get_global_rank(group, 0)
        path: List[Optional[str]] = [None]
        if self.rank == 0:
            path[0] = os.path.join(stage_dir(size), name)
            fd = os.open(path[0], os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
            try:
                os.ftruncate(fd, size)
            except OSError:
                os.close(fd)
                os.unlink(path[0])
                raise
        else:
            fd = None
        try:
            dist.broadcast_object_list(path, src=root, group=group)
            if fd is None:
                fd = os.open(path[0], os.O_RDWR)
            try:
                self._map = mmap.mmap(fd, size, mmap.MAP_SHARED)
            finally:
                os.close(fd)
            # every rank holds the mapping before the name goes
            dist.barrier(group=group)
        finally:
            if self.rank == 0 and os.path.exists(path[0]):
                os.unlink(path[0])
        flat = torch.frombuffer(self._map, dtype=torch.uint8)
        self.buffers = [
            flat[off:off + numel * torch.empty((), dtype=d).element_size()]
            .view(d) for off, (numel, d) in zip(offsets, specs)]
        cells = np.frombuffer(self._map, dtype=np.int64,
                              count=n_leaves * self.k + n_leaves)
        self.landed = cells[:n_leaves * self.k].reshape(n_leaves, self.k)
        self.pulled = cells[n_leaves * self.k:]
        self.pinned = device.type == "cuda"
        if self.pinned:
            ptr = flat.data_ptr()
            with torch.cuda.device(device):
                torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(
                    ptr, size, 0))
            self._unpin = weakref.finalize(self, _unpin, ptr)

    def land(self, leaf: int, step: int) -> None:
        """This rank's slice of ``leaf`` for round ``step`` is in the
        segment."""
        self.landed[leaf, self.rank] = step

    def wait_landed(self, leaf: int, rank: int, step: int,
                    what: str) -> None:
        self._wait(lambda: self.landed[leaf, rank] >= step,
                   f"local rank {rank}'s slice of {what} did not land in "
                   f"the shared staging for round {step}")

    def mark_pulled(self, leaf: int, step: int, ok: bool = True) -> None:
        self.pulled[leaf] = step if ok else -step

    def wait_pulled(self, leaf: int, step: int, what: str) -> None:
        self._wait(lambda: abs(int(self.pulled[leaf])) >= step,
                   f"local rank 0 (the root) did not pull {what} for "
                   f"round {step}")
        if self.pulled[leaf] == -step:
            raise RuntimeError(f"the local root's push or pull of {what} "
                               f"failed in round {step}")

    @staticmethod
    def _wait(done, what: str) -> None:
        limit = timeout_s()
        deadline = time.monotonic() + limit
        pause = 1e-5
        while not done():
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"{what} within BYTEPS_TAP_TIMEOUT_S ({limit:g} s): "
                    "a process of the local group died or is stuck")
            time.sleep(pause)
            pause = min(2 * pause, 1e-3)

    def close(self) -> None:
        """Unpin the mapping; it is unmapped once no buffer views it."""
        if self.pinned:
            self._unpin()
        self.buffers = []
