"""Build and load the port's CUDA kernels (``byteps_tpu_torch/csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface under ``build/byteps_tpu_torch/`` at first use, and
loaded with ``ctypes``; no PyTorch headers are compiled, so a build takes
seconds. Nothing here runs when the package is imported: the CPU tests
import every module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict, List

from byteps_tpu_torch.core.build import install, is_fresh

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build",
                         "byteps_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: ``$NVCC``, then ``$CUDA_HOME/bin``, then PATH."""
    cands = [os.environ.get("NVCC", ""),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"),
             shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set NVCC or CUDA_HOME): the CUDA kernels of "
        "byteps_tpu_torch are compiled at first use on the GPU machine")


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def inputs(name: str) -> List[str]:
    """Files a build of ``csrc/<name>.cu`` depends on: the source and every
    header beside it (``csrc/*.cuh``), so an edited header rebuilds."""
    headers = sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                     if f.endswith(".cuh"))
    return [os.path.join(CSRC, f"{name}.cu"), *headers]


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless the library is fresh: newer than
    the source and its headers (``inputs``) and built by the same ``nvcc``
    with the same flags (the core's ``is_fresh`` rule).

    The compiler's report (registers, shared memory and spills of every
    kernel, from ``-Xptxas -v``) is kept beside the library as
    ``<name>.nvcc.log``.
    """
    src = os.path.join(CSRC, f"{name}.cu")
    out = lib_path(name)
    compiler = nvcc()
    key = " ".join([os.path.realpath(compiler), *NVCC_FLAGS])
    if is_fresh(out, inputs(name), key):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [compiler, *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.join(BUILD_DIR, f"{name}.nvcc.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr[-4000:]}")
    install(tmp, out, key)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build(name))
        return lib
