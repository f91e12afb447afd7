"""A loopback stand-in for the port's C-core client (``ffi.Worker``).

One worker and no server: a push_pull's sum (and mean) is the array
itself, so the core's in-place pull leaves it as it is. The client
records what the port asks of the core (declares, pushes, waits), from
any thread. ``fail`` (handle, tensor id) -> bool makes ``wait`` and
``poll`` of the chosen handles raise, as the core does for a push whose
peer died. It imports no JAX, so tests on the card use it too.
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

    def declare(self, name, nelem, dtype, compression=None):
        with self.lock:
            self.declares.append((name, int(nelem), str(dtype), compression))
            return len(self.declares) - 1

    def push_pull(self, tensor_id, arr, average=True, async_mode=False,
                  dtype=None):
        assert isinstance(arr, np.ndarray) and arr.flags["C_CONTIGUOUS"]
        assert arr.size == self.declares[tensor_id][1], "size != declared"
        assert (dtype or str(arr.dtype)) == self.declares[tensor_id][2]
        with self.lock:
            h = len(self.tid_of)
            self.tid_of[h] = tensor_id
            self.pushes.append(tensor_id)
            self.push_threads.append(threading.current_thread().name)
            return h

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
