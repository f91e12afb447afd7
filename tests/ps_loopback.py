"""A loopback stand-in for the port's C-core client (``ffi.Worker``).

One worker and no server: a push_pull's sum (and mean) is the array
itself, so the core's in-place pull leaves it as it is. The async mode
is the servers' (``BYTEPS_ENABLE_ASYNC``): ``broadcast`` seeds a key
with the array, and an async ``push_pull`` adds the array (a delta) to
the key's value and pulls the sum into it; a key that was never seeded
starts from the first delta, as a server's does. The client records what
the port asks of the core (declares, pushes, waits), from any thread.
``fail`` (handle, tensor id) -> bool makes ``wait`` and ``poll`` of the
chosen handles raise, as the core does for a push whose peer died. It
imports no JAX, so tests on the card use it too, and the JAX package's
bridge can run on it.
"""

import threading

import numpy as np

import byteps_tpu_torch as bps
from byteps_tpu_torch.core import ffi


class LoopbackClient:
    def __init__(self, fail=None):
        self.lock = threading.Lock()
        self.fail = fail
        self.declares = []  # (name, numel, dtype, compression), in order
        self.pushes = []  # tensor ids, in enqueue order
        self.push_threads = []  # the thread of each push
        self.waited = []  # handles, in wait order
        self.tid_of = {}  # handle -> tensor id
        self.values = {}  # tensor id -> the async servers' copy

    def worker_rank(self):
        return 0

    def num_workers(self):
        return 1

    def declare(self, name, nelem, dtype, compression=None):
        with self.lock:
            self.declares.append((name, int(nelem), str(dtype), compression))
            return len(self.declares) - 1

    def _check(self, tensor_id, arr, dtype):
        assert isinstance(arr, np.ndarray) and arr.flags["C_CONTIGUOUS"]
        assert arr.size == self.declares[tensor_id][1], "size != declared"
        assert (dtype or str(arr.dtype)) == self.declares[tensor_id][2]

    def _handle(self, tensor_id):
        h = len(self.tid_of)
        self.tid_of[h] = tensor_id
        return h

    def push_pull(self, tensor_id, arr, average=True, async_mode=False,
                  dtype=None):
        self._check(tensor_id, arr, dtype)
        with self.lock:
            if async_mode:
                seed = self.values.get(tensor_id)
                self.values[tensor_id] = (arr.copy() if seed is None
                                          else seed + arr)
                arr[...] = self.values[tensor_id]
            self.pushes.append(tensor_id)
            self.push_threads.append(threading.current_thread().name)
            return self._handle(tensor_id)

    def broadcast(self, tensor_id, arr, root_rank=0, dtype=None):
        self._check(tensor_id, arr, dtype)
        with self.lock:
            self.values[tensor_id] = arr.copy()
            return self._handle(tensor_id)

    def wait(self, handle):
        with self.lock:
            self.waited.append(handle)
            tid = self.tid_of[handle]
        if self.fail is not None and self.fail(handle, tid):
            raise RuntimeError(f"byteps push/pull failed: loopback failure "
                               f"of tensor {tid}")

    def poll(self, handle):
        self.wait(handle)
        return True

    def shutdown(self):
        pass


def init_loopback(monkeypatch, client, device="cpu"):
    """``bps.init`` in PS mode with ``client`` in place of the core's."""
    monkeypatch.setenv("BYTEPS_PS_MODE", "ps")
    monkeypatch.setattr(ffi.Worker, "start",
                        classmethod(lambda cls, cfg: client))
    bps.init(device=device)
