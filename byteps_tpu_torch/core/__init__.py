"""C++ core runtime: DCN KV transport, CPU-summation parameter server,
priority-credit scheduler, compression codecs. See csrc/ for the C++
sources, build.py for compilation, ffi.py for the ctypes bindings."""

from byteps_tpu_torch.core.ffi import (  # noqa: F401
    Replica,
    Scheduler,
    Server,
    Worker,
    ensure_built,
)
