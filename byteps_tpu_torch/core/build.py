"""Build the byteps_tpu C++ core into libbyteps_core.so.

Run as ``python -m byteps_tpu_torch.core.build`` (reference analogue: the
setup.py c_lib extension build, SURVEY.md §2.6). No external deps — plain
g++; OpenMP is enabled when available (the PS summation hot loop,
cpu_reducer.cc, parallelises across the server's spare cores).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

CORE_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(CORE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CORE_DIR)),
                         "build", "byteps_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libbyteps_core.so")

SOURCES = [
    "debug.cc",
    "crc32c.cc",
    "trace.cc",
    "tenancy.cc",
    "roundstats.cc",
    "events.cc",
    "van.cc",
    "postoffice.cc",
    "cpu_reducer.cc",
    "compressor.cc",
    "ckpt.cc",
    "server.cc",
    "worker.cc",
    "c_api.cc",
]


def is_fresh(lib_path: str, inputs, key: str) -> bool:
    """Whether ``lib_path`` exists, is newer than every file in
    ``inputs``, and was built with ``key`` (the compiler's path and its
    flags), as recorded in the ``<lib>.stamp`` file beside it."""
    try:
        with open(lib_path + ".stamp") as f:
            if f.read() != key:
                return False
        lib_mtime = os.path.getmtime(lib_path)
    except OSError:
        return False
    return all(os.path.getmtime(p) < lib_mtime for p in inputs)


def install(tmp_path: str, lib_path: str, key: str) -> None:
    """Move a freshly linked library into place and record its ``key``.
    The rename is atomic: a process that loads the library while another
    is still linking never sees a half-written file."""
    os.replace(tmp_path, lib_path)
    with open(lib_path + ".stamp", "w") as f:
        f.write(key)


def _supports_flag(cxx: str, flag: str) -> bool:
    # Compile AND link: -fopenmp passes a syntax-only check on toolchains
    # that then fail to link it (no libgomp.spec).
    with tempfile.TemporaryDirectory() as d:
        probe = subprocess.run(
            [cxx, flag, "-x", "c++", "-", "-o", os.path.join(d, "probe")],
            input="int main(){return 0;}", text=True,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    return probe.returncode == 0


def build(force: bool = False, verbose: bool = True,
          sanitize: str = "") -> str:
    """Compile unless the library is fresh (``is_fresh``): newer than
    every source and header, and built by the same compiler with the same
    flags. Returns the lib path.

    ``sanitize``: "address" or "thread" builds an instrumented variant
    (libbyteps_core.asan.so / .tsan.so). The reference relies on CHECK
    macros alone (SURVEY.md §5 "no TSAN/ASAN CI"); these builds are how
    byteps_tpu races/UAFs get caught — an exit-order use-after-free in the
    shutdown path was found exactly this way. Run with:

        BPS_CORE_LIB=.../libbyteps_core.asan.so \
        LD_PRELOAD=$(g++ -print-file-name=libasan.so) python ...
    """
    lib_path = LIB_PATH
    if sanitize:
        assert sanitize in ("address", "thread"), sanitize
        suffix = {"address": ".asan.so", "thread": ".tsan.so"}[sanitize]
        lib_path = LIB_PATH[:-3] + suffix
    srcs = [os.path.join(CSRC, s) for s in SOURCES]
    hdrs = [os.path.join(CSRC, h) for h in os.listdir(CSRC)
            if h.endswith(".h")]
    cxx = os.environ.get("CXX", "g++")
    if sanitize:
        flags = ["-O1", "-g", "-std=c++17", "-fPIC", "-shared", "-pthread",
                 "-Wall", f"-fsanitize={sanitize}",
                 "-fno-omit-frame-pointer"]
    else:
        flags = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
                 "-Wall"]
    # the probed flags below depend only on the compiler, which the key
    # names by its resolved path
    key = " ".join([os.path.realpath(shutil.which(cxx) or cxx), *flags])
    if not force and is_fresh(lib_path, srcs + hdrs, key):
        return lib_path

    if not sanitize:
        # --exclude-libs: a toolchain that links libstdc++ statically
        # would otherwise export that private copy, and a process that
        # already loaded the system libstdc++ (torch's) then mixes the two
        # and crashes in the first iostream call.
        for extra in ("-march=native", "-fopenmp",
                      "-Wl,--exclude-libs,ALL"):
            if _supports_flag(cxx, extra):
                flags.append(extra)
    # -lrt: shm_open/shm_unlink (the shm van transport) live in librt on
    # glibc < 2.34; on newer glibc the library is an empty stub, so
    # linking it unconditionally is safe and keeps dlopen from failing
    # with "undefined symbol: shm_open" on older hosts.
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    tmp_path = f"{lib_path}.{os.getpid()}.tmp"
    # one compiler process a source, all started together (the longest
    # source sets the build's time), then one link
    objdir = tempfile.mkdtemp(dir=os.path.dirname(lib_path))
    try:
        compile_flags = [f for f in flags
                         if f != "-shared" and not f.startswith("-Wl,")]
        objs = [os.path.join(objdir, os.path.basename(src) + ".o")
                for src in srcs]
        cmds = [[cxx, *compile_flags, "-c", src, "-o", obj]
                for src, obj in zip(srcs, objs)]
        cmds.append([cxx, *flags, *objs, "-o", tmp_path, "-lrt"])
        if verbose:
            for cmd in cmds:
                print("[byteps_tpu_torch.core.build]", " ".join(cmd))
        compiles = [subprocess.Popen(cmd) for cmd in cmds[:-1]]
        failed = [cmd[-3] for cmd, p in zip(cmds, compiles) if p.wait()]
        if failed:
            raise subprocess.CalledProcessError(
                1, f"{cxx} -c {' '.join(failed)}")
        subprocess.run(cmds[-1], check=True)
    finally:
        shutil.rmtree(objdir, ignore_errors=True)
    install(tmp_path, lib_path, key)
    return lib_path


if __name__ == "__main__":
    san = ""
    if "--asan" in sys.argv:
        san = "address"
    elif "--tsan" in sys.argv:
        san = "thread"
    print(build(force="--force" in sys.argv, sanitize=san))
